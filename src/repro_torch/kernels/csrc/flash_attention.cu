// Causal GQA flash attention, forward, for sm_90a (H100).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention_fwd (body _flash_kernel). Same function: causal attention with
// all H/Hkv query heads of one kv head sharing K/V, an optional sliding window
// given at run time (0 = full), an optional tanh logit soft-cap, an fp32 online
// softmax, bf16 or fp32 in and out.
//
// Query offset: q holds Sq positions from global position q_off on, k and v
// Sk >= q_off + Sq (a rank's shard of the sequence against every key, as the
// "sequence" attention mode runs prefill). Every mask, tile range and causal
// bound is taken at global positions q_off + row; loads of q and stores of o
// at the local row. With q_off = 0 and Sk = Sq the arithmetic is the
// whole-sequence call's, instruction for instruction.
//
// What bounds it on the H100: the two products (QK^T and PV) are compute; at
// gemma2-2b's prefill (B=2, S=4352, H=8, D=256) one launch is ~1.55e11 FLOPs,
// 0.16 ms at the 989 TFLOP/s bf16 tensor-core peak, against ~107 MB of q, k, v
// and o (32 us at 3.35 TB/s). So the products belong on the tensor cores, and
// on Hopper only wgmma reaches their full rate.
//
// Both paths share the work split: a block owns consecutive "flat rows" of one
// (batch, kv head), where a flat row is (query position, head within the
// group). The group's heads share every K/V tile the block loads, as in the
// TPU kernel, and a group that is not a power of two (3 for smollm) needs no
// special case.
//
// bf16 with head_dim 64, 112, 128, 160 or 256 (gemma2-2b's 256, stablelm-12b's
// 160, zamba2-7b's 112): flash_wgmma_kernel, built for Hopper's tensor-core
// pipeline. The template takes any multiple of 16 from 64 to 256; the launcher
// instantiates those five.
//  * A CTA owns 128 flat rows (128 / group positions x group heads; 126 rows
//    for a group of 3) and has three warpgroups: two consumers of 64 rows each
//    and one producer. setmaxnreg gives the consumers 240 registers a thread
//    (the fp32 O accumulator alone is 128 at D=256) and the producer 24.
//  * The producer's one thread loads Q once and then keeps rings of 2 K and
//    2 V tiles of 64 keys in flight with TMA, each stage under a full and an
//    empty mbarrier. The tensor maps cover q (B,S,H,D) and k/v (B,S,Hkv,D) in
//    place; a box is 64 columns (128 bytes, the widest a 128-byte swizzle
//    takes), so a 256-wide row is four boxes and a 160-wide row three, the
//    last box's columns 160..191 past the map's edge: TMA fills them with
//    zeros and reads no bytes for them. Q's box is {64, group heads,
//    128 / group positions}, which lands the flat rows in order. Keys and
//    positions past S arrive as zeros.
//  * S = Q K^T is wgmma.m64n64k16 with both operands read from shared memory
//    (K-major descriptors), D / 16 k-steps: only those holding real columns
//    (10 at D=160, 7 at 112). The softmax stays in registers: scale, tanh cap
//    (tanh.approx), the mask only on tiles that cross the diagonal or the
//    window's lower edge, the running max over a quad, exp2 with log2(e)
//    folded into the scale. O += P V is wgmma.m64n{D}k16 with P rounded to
//    bf16 in registers as the A operand (S's accumulator layout is the A
//    fragment of the next product) and V read as an MN-major B: one PV
//    product per tile, P rounded where the JAX and port plain paths round it.
//    N = D itself (n160, n112: legal shapes, multiples of 8 up to 256): the
//    B descriptor steps a box (LBO) every 64 columns, and a product of N = D
//    reads no zero column of the last box.
//  * Overlap: a consumer issues S of tile i and PV of tile i-1 together and
//    runs tile i's softmax while PV is in flight; K is released as soon as S
//    is done, V after PV. The two consumers take turns to issue (two named
//    barriers), so one's softmax runs under the other's products.
//  * q tiles launch last positions first, so the heaviest causal CTAs are
//    not left for the tail. The epilogue divides by l, stages each
//    warpgroup's bf16 O tile in its own Q rows (free after its last S) and
//    stores the D / 8 16-byte pieces of each row, never the padded columns
//    (at D=160 those would land on the next head's row). Rows past S (and
//    past the Q box) are computed and not stored.
//  * The wrapper raises on what TMA cannot take (a base pointer off a 16-byte
//    boundary; the row strides of contiguous bf16 rows of these head_dims,
//    2 D bytes, are multiples of 16). A group above 8 is launched by the
//    wrapper in passes of at most 8 query heads a kv head (the launcher
//    refuses it).
//
// Any other case (fp32 at any head_dim; bf16 at a head_dim not listed above,
// 320 and 576 among them): flash_fwd_kernel, on the fp32 CUDA cores, which
// keeps the fp32 inputs exact.
//  * 4 warps x 8 rows. K/V tiles of 32 keys go through shared memory in fp32;
//    in the score step lane j owns key j of the tile (dot over D with float4
//    loads; the K tile's row stride is D+4 floats so the 8 lanes of a quarter
//    warp hit distinct banks); in the PV step lane j owns output columns
//    4j..4j+3 (+128), and each key's weight is broadcast with __shfl_sync.
//  * head_dim up to 256: the fp32 accumulator of a row is spread over the
//    warp's 32 lanes (8 floats a lane at D=256), so 8 rows cost 64 registers.
//    Shared memory at D=256 is 97 KB.
//  * head_dim above 256 (WIDE): neither registers nor shared memory grow
//    with D. The grid's z axis runs the PV product in passes of 256 output
//    columns; each pass recomputes the scores over the whole head_dim,
//    loading Q and K 256 columns at a time (Q again for every key tile),
//    and keeps only its 256 columns of V and of the accumulator. Every pass
//    sums the scores in the same order, so they share m and l bit for bit.
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
#include <stdint.h>

#include "tma.cuh"  // tensor maps, TMA loads and mbarriers

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

constexpr int WIDE_COLS = 256;               // head-dim columns of a WIDE chunk or pass

// the Q tile's columns d0 .. d0 + Dp - 1 (zero past D): flat row r ->
// position r / group, head kvh * group + r % group
template <typename T>
__device__ __forceinline__ void load_q(float* Qs, const T* __restrict__ q, long long row0,
                                       long long n_rows, int group, int b, int kvh, int S,
                                       int H, int D, int d0, int Dp, int tid) {
  for (int idx = tid; idx < BLOCK_ROWS * Dp; idx += THREADS) {
    const int r = idx / Dp, d = idx % Dp;
    const long long fr = row0 + r;
    float x = 0.f;
    if (fr < n_rows && d0 + d < D) {
      const long long qp = fr / group;
      const int h = kvh * group + (int)(fr % group);
      x = to_f32(q[((b * (long long)S + qp) * H + h) * D + d0 + d]);
    }
    Qs[idx] = x;
  }
}

// NCH: 128-column chunks of the head dim a lane covers in the PV step
// (1 for D <= 128, 2 for D <= 256 and for WIDE). Dp: the columns held in
// shared memory, D rounded up to 4 (WIDE: 256).
template <typename T, int NCH, bool WIDE>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 int S, int Sk, int q_off, int H, int Hkv, int D, int Dp, int window,
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
  const int c0 = WIDE ? blockIdx.z * WIDE_COLS : 0;   // this pass's output columns
  const long long n_rows = (long long)S * group;
  const long long row0 = (long long)blockIdx.x * BLOCK_ROWS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (!WIDE) load_q(Qs, q, row0, n_rows, group, b, kvh, S, H, D, 0, Dp, tid);

  int qpos[ROWS];
  float m[ROWS], l[ROWS], s[ROWS];
  float4 acc[ROWS][NCH];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    qpos[i] = q_off + (int)((row0 + warp * ROWS + i) / group);   // global
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  const int qpos_min = q_off + (int)(row0 / group);
  const int qpos_max = q_off + (int)min((row0 + BLOCK_ROWS - 1) / group, (long long)S - 1);
  const int k_begin = window > 0 ? max(0, qpos_min - window + 1) : 0;
  const int k_end = qpos_max + 1;

  for (int t0 = (k_begin / BK) * BK; t0 < k_end; t0 += BK) {
    __syncthreads();  // the previous tile is consumed (and, first time, Qs is written)
    for (int idx = tid; idx < BK * Dp; idx += THREADS) {
      const int kk = idx / Dp, d = idx % Dp;
      const int key = t0 + kk;
      float kx = 0.f, vx = 0.f;
      if (key < Sk && c0 + d < D) {
        const long long off = ((b * (long long)Sk + key) * Hkv + kvh) * D + c0 + d;
        if (!WIDE) kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      if (!WIDE) Ks[kk * kstr + d] = kx;
      Vs[kk * Dp + d] = vx;
    }

    // scores: lane owns key t0 + lane; WIDE: over Q and K 256 columns at a time
#pragma unroll
    for (int i = 0; i < ROWS; ++i) s[i] = 0.f;
    const float* krow = Ks + lane * kstr;
    const float* qrow = Qs + warp * ROWS * Dp;
    for (int d0 = 0; d0 < (WIDE ? D : 1); d0 += WIDE_COLS) {
      if (WIDE) {
        __syncthreads();  // the previous chunk is consumed
        load_q(Qs, q, row0, n_rows, group, b, kvh, S, H, D, d0, Dp, tid);
        for (int idx = tid; idx < BK * Dp; idx += THREADS) {
          const int kk = idx / Dp, d = idx % Dp;
          const int key = t0 + kk;
          Ks[kk * kstr + d] = key < Sk && d0 + d < D
                                  ? to_f32(k[((b * (long long)Sk + key) * Hkv + kvh) * D + d0 + d])
                                  : 0.f;
        }
      }
      __syncthreads();
      const int dw = WIDE ? min(Dp, (D - d0 + 3) / 4 * 4) : Dp;
#pragma unroll 2
      for (int d = 0; d < dw; d += 4) {
        const float4 kx = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          const float4 qx = *reinterpret_cast<const float4*>(qrow + i * Dp + d);
          s[i] += qx.x * kx.x + qx.y * kx.y + qx.z * kx.z + qx.w * kx.w;
        }
      }
    }

    // online softmax, one row at a time; all lanes hold the row's m and l
    const int key = t0 + lane;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      float x = s[i] * scale;
      if (cap > 0.f) x = tanhf(x / cap) * cap;
      const bool ok = key < Sk && key <= qpos[i] && (window <= 0 || key > qpos[i] - window);
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
    T* orow = o + ((b * (long long)S + qpos[i] - q_off) * H + h) * D + c0;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int d0 = c * 128 + 4 * lane;
      const float a[4] = {acc[i][c].x, acc[i][c].y, acc[i][c].z, acc[i][c].w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c0 + d0 + e < D) store(orow + d0 + e, a[e] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 tensor-core path: wgmma fed by TMA, warp-specialised
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;
constexpr int WG = 128;                      // threads of a warpgroup
constexpr int TROWS = 128;                   // flat query rows of a CTA: 2 consumers x 64
constexpr int TBK = 64;                      // keys of a K/V tile
constexpr int STAGES = 2;                    // K/V tiles in flight
constexpr int CHUNK = TMA_BOX_COLS;          // head-dim columns of one 128-byte swizzled box
constexpr int TC_THREADS = 3 * WG;           // consumer, consumer, producer warpgroups
constexpr int MAX_GROUP = 8;
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory of one CTA, in bytes from a 1024-aligned base (the 128-byte
// swizzle repeats every 8 rows of 128 bytes). Each tile is stored as
// ceil(D / 64) column chunks; a chunk is its rows of 128 bytes, as one TMA box
// writes it (the last one zero past D). D=160: 3 chunks, 144 KB in all.
template <int D>
struct Smem {
  static_assert(D % 16 == 0 && D >= 64 && D <= 256, "head_dim: a multiple of 16 in 64..256");
  static constexpr int NCH = (D + CHUNK - 1) / CHUNK;
  static constexpr int Q_CHUNK = TROWS * 128;
  static constexpr int KV_CHUNK = TBK * 128;
  static constexpr int Q = 0;
  static constexpr int K = Q + NCH * Q_CHUNK;
  static constexpr int V = K + STAGES * NCH * KV_CHUNK;
  static constexpr int BAR = V + STAGES * NCH * KV_CHUNK;   // q; full, empty of K; of V
  static constexpr int BYTES = BAR + 8 * (1 + 4 * STAGES) + 1024;
};

// MUFU.TANH, one instruction; tanhf is a dozen and bounded the softmax
// (kernels/ablate_flash.py times both). Its error of ~2^-11 reads as tanhf
// does per row in chip_smoke.py's capped q_std 8 prefill case (PERF.md).
__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// MUFU.EX2 without exp2f's range handling; -inf and large negatives give 0
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, each in 16-byte units
__device__ __forceinline__ uint64_t sdesc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups are in flight
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of accumulators across a wgmma
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// S (64 x 64 keys, f32) (+)= Q (64 x 16, smem, K-major) * K^T (smem, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// O (64 x N, f32) += P (64 x 16 keys, bf16 in registers) * V (16 x N, smem, MN-major)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<112>(float (&d)[56], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55},"
      "{%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<160>(float (&d)[80], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
      "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79},"
      "{%80, %81, %82, %83}, %84, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
        "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
      "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
      "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
      "%124, %125, %126, %127},"
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
        "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
        "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),
        "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]),
        "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]),
        "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]),
        "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
        "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
        "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// named barriers 1 and 2 (0 is __syncthreads) order the two consumers' issue;
// 3 and 4 close each consumer's staging of O
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(id) : "memory");
}

// S accumulator layout (m64nN, f32; PTX ISA, wgmma register fragments): warp
// w of the warpgroup holds rows 16w + g and 16w + g + 8 (g = lane / 4, t =
// lane % 4); d[4j + 0..1] are row g, columns 8j + 2t + 0..1, and d[4j + 2..3]
// row g + 8, the same columns. The bf16 A fragment of a k16 step from
// registers takes rows {g, g+8} x columns {2t, 2t+1, 2t+8, 2t+9}: for keys
// 16kk..16kk+15 that is exactly S's d[8kk .. 8kk + 7], packed in pairs.
//
// The online softmax of one tile's scores, in registers: s in, p out (f32),
// m and l updated, corr the factor for O
template <bool CAP>
__device__ __forceinline__ void softmax_tile(float (&s)[32], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], const int (&qpos)[2], int t0,
                                             int t, bool masked, int window, float pre,
                                             float post) {
#pragma unroll
  for (int e = 0; e < 32; ++e) s[e] = CAP ? tanh_approx(s[e] * pre) * post : s[e] * pre;
  if (masked) {
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int qp = qpos[(e >> 1) & 1];
      const int key = t0 + 8 * (e >> 2) + 2 * t + (e & 1);
      if (key > qp || (window > 0 && key <= qp - window)) s[e] = NEG_INF;
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int e = 0; e < 32; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
    corr[r] = ex2_approx(m[r] - mx[r]);
    m[r] = mx[r];
  }
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    s[e] = ex2_approx(s[e] - m[(e >> 1) & 1]);
    sum[(e >> 1) & 1] += s[e];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];   // this thread's share
}

template <int D, bool CAP>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ o, int S,
                   int q_off, int H, int Hkv, int n_bh, int P, int n_qtiles, int window,
                   float scale, float cap) {
  using L = Smem<D>;
  constexpr int NCH = L::NCH;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  // barriers: q; then full and empty of each K stage and of each V stage
  const uint32_t q_bar = base + L::BAR;
  const uint32_t k_full = q_bar + 8, k_empty = k_full + 8 * STAGES;
  const uint32_t v_full = k_empty + 8 * STAGES, v_empty = v_full + 8 * STAGES;

  const int group = H / Hkv;
  const int rows = P * group;                         // flat rows of this CTA (<= TROWS)
  const int bh = blockIdx.x % n_bh;
  const int b = bh / Hkv, kvh = bh % Hkv;
  // the last positions first: the heaviest causal tiles start in the first wave.
  // q0: the CTA's first local row of q; g0: its global position
  const int q0 = (n_qtiles - 1 - (int)(blockIdx.x / n_bh)) * P;
  const int g0 = q_off + q0;
  const int qmax = q_off + min(q0 + P - 1, S - 1);
  const int k_begin = window > 0 ? max(0, g0 - window + 1) : 0;
  const int t_begin = k_begin / TBK * TBK;
  const int n_tiles = (qmax + 1 - t_begin + TBK - 1) / TBK;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(k_full + 8 * st, 1);
      mbar_init(v_full + 8 * st, 1);
      mbar_init(k_empty + 8 * st, 8);                 // one arrival per consumer warp
      mbar_init(v_empty + 8 * st, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / WG;
  if (wg == 2) {
    // producer: one thread issues every TMA load; the rest of the warpgroup
    // only hands its registers to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 2 * WG) {
      // Q once: box {64 columns, group heads, P positions} = flat rows in order
      mbar_expect_tx(q_bar, NCH * rows * 128);
      for (int c = 0; c < NCH; ++c)
        tma_load(base + L::Q + c * L::Q_CHUNK, &qmap, q_bar, c * CHUNK, kvh * group, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % STAGES, phase = ((i / STAGES) & 1) ^ 1;
        const int t0 = t_begin + i * TBK;             // keys past Sk arrive as zeros
        mbar_wait(k_empty + 8 * st, phase);
        mbar_expect_tx(k_full + 8 * st, NCH * L::KV_CHUNK);
        for (int c = 0; c < NCH; ++c)
          tma_load(base + L::K + (st * NCH + c) * L::KV_CHUNK, &kmap, k_full + 8 * st,
                   c * CHUNK, kvh, t0, b);
        mbar_wait(v_empty + 8 * st, phase);
        mbar_expect_tx(v_full + 8 * st, NCH * L::KV_CHUNK);
        for (int c = 0; c < NCH; ++c)
          tma_load(base + L::V + (st * NCH + c) * L::KV_CHUNK, &vmap, v_full + 8 * st,
                   c * CHUNK, kvh, t0, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x % WG, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int r0 = wg * 64 + warp * 16 + g;           // this thread's rows: r0, r0 + 8
    const int qpos[2] = {g0 + r0 / group, g0 + (r0 + 8) / group};      // global
    const int wq_min = g0 + wg * 64 / group, wq_max = g0 + (wg * 64 + 63) / group;
    // scores in log2 units: exp2(x log2e - m log2e) = exp(x - m)
    const float pre = CAP ? scale / cap : scale * LOG2E;
    const float post = CAP ? cap * LOG2E : 1.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, corr[2];
    float acc[D / 2], s[32];
    uint32_t pa[4][4];                                // P of the previous tile, bf16
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    const uint32_t q_rows = base + L::Q + wg * 64 * 128;
    const int my_turn = 1 + wg, their_turn = 2 - wg;

    // S = Q K^T over D in k16 steps: +32 bytes inside a 128-byte swizzled
    // row, the next column chunk past 4 steps; none over the zero columns
    auto issue_s = [&](int st) {
      const uint32_t k_tile = base + L::K + st * NCH * L::KV_CHUNK;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_ss_n64(s, sdesc(q_rows + (ks / 4) * L::Q_CHUNK + (ks % 4) * 32, 16, 1024),
                     sdesc(k_tile + (ks / 4) * L::KV_CHUNK + (ks % 4) * 32, 16, 1024), ks > 0);
      wg_commit();
    };
    // O += P V: V's k16 step is 16 keys = 2048 bytes; its column chunks lie
    // KV_CHUNK apart
    auto issue_pv = [&](int st) {
      const uint32_t v_tile = base + L::V + st * NCH * L::KV_CHUNK;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<D>(acc, pa[kk], sdesc(v_tile + kk * 16 * 128, L::KV_CHUNK, 1024));
      wg_commit();
    };
    // the mask only where a tile crosses the diagonal or the window's lower
    // edge of this warpgroup's rows (keys past Sk lie past the diagonal)
    auto masked = [&](int t0) {
      return t0 + TBK - 1 > wq_min || (window > 0 && t0 <= wq_max - window);
    };
    // P rounded to bf16 once, as the plain paths round it before PV
    auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
    };
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };

    mbar_wait(q_bar, 0);
    mbar_wait(k_full, 0);
    wg_fence();
    issue_s(0);
    wg_wait<0>();
    reg_fence(s);
    release(k_empty);
    softmax_tile<CAP>(s, m, l, corr, qpos, t_begin, t, masked(t_begin), window, pre, post);
    pack_p();
    // ping-pong: the consumers take turns to issue their products, so that
    // one warpgroup's softmax runs under the other's wgmma; warpgroup 0 first
    if (wg == 1 && n_tiles > 1) named_arrive(their_turn);
    for (int i = 1; i < n_tiles; ++i) {
      const int st = i % STAGES, prev = (i - 1) % STAGES;
      const int t0 = t_begin + i * TBK;
      mbar_wait(k_full + 8 * st, (i / STAGES) & 1);
      mbar_wait(v_full + 8 * prev, ((i - 1) / STAGES) & 1);
      named_sync(my_turn);
      reg_fence(s);
      reg_fence(acc);
      wg_fence();
      issue_s(st);                                    // S of this tile
      issue_pv(prev);                                 // under it, PV of the previous one
      if (wg == 0 || i < n_tiles - 1) named_arrive(their_turn);
      wg_wait<1>();
      reg_fence(s);
      release(k_empty + 8 * st);
      softmax_tile<CAP>(s, m, l, corr, qpos, t0, t, masked(t0), window, pre, post);
      wg_wait<0>();
      reg_fence(acc);
      release(v_empty + 8 * prev);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[4 * n] *= corr[0]; acc[4 * n + 1] *= corr[0];
        acc[4 * n + 2] *= corr[1]; acc[4 * n + 3] *= corr[1];
      }
      pack_p();
    }
    const int last = (n_tiles - 1) % STAGES;
    mbar_wait(v_full + 8 * last, ((n_tiles - 1) / STAGES) & 1);
    reg_fence(acc);
    wg_fence();
    issue_pv(last);
    wg_wait<0>();
    reg_fence(acc);
    release(v_empty + 8 * last);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(FULL, l[r], 1);
      l[r] += __shfl_xor_sync(FULL, l[r], 2);
    }
    // stage O in this warpgroup's Q rows (free once its last S is done), in
    // the same 128-byte swizzle, then store whole rows in 16-byte pieces
    uint8_t* rows_smem = smem_raw + (base - smem_u32(smem_raw)) + L::Q + wg * 64 * 128;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rr = warp * 16 + g + 8 * r;
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(rows_smem + (n / 8) * L::Q_CHUNK + rr * 128 +
                                     ((n % 8) ^ (rr % 8)) * 16 + 4 * t) =
            pack_bf16(acc[4 * n + 2 * r] * inv, acc[4 * n + 2 * r + 1] * inv);
    }
    asm volatile("bar.sync %0, 128;\n" :: "r"(3 + wg) : "memory");
    for (int idx = tid; idx < 64 * (D / 8); idx += WG) {
      const int rr = idx / (D / 8), j = idx % (D / 8);
      const int row = wg * 64 + rr, qp = q0 + row / group;
      if (row >= rows || qp >= S) continue;           // past this CTA's box, or past S
      const int h = kvh * group + row % group;
      *reinterpret_cast<uint4*>(o + (((long long)b * S + qp) * H + h) * D + j * 8) =
          *reinterpret_cast<const uint4*>(rows_smem + (j / 8) * L::Q_CHUNK + rr * 128 +
                                          ((j % 8) ^ (rr % 8)) * 16);
    }
  }
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o, int B, int S,
                         int Sk, int q_off, int H, int Hkv, int window, float scale, float cap,
                         cudaStream_t stream) {
  const int group = H / Hkv;
  if (group > MAX_GROUP) return cudaErrorInvalidValue;
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const int P = TROWS / group;                        // query positions of a CTA
  CUtensorMap qm, km, vm;
  if (!make_map(enc, &qm, q, B, S, H, D, group, P) ||
      !make_map(enc, &km, k, B, Sk, Hkv, D, 1, TBK) ||
      !make_map(enc, &vm, v, B, Sk, Hkv, D, 1, TBK))
    return cudaErrorInvalidValue;
  auto kern = cap > 0.f ? flash_wgmma_kernel<D, true> : flash_wgmma_kernel<D, false>;
  const int smem = Smem<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int n_qtiles = (S + P - 1) / P;
  const long long grid = (long long)n_qtiles * B * Hkv;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  kern<<<(unsigned)grid, TC_THREADS, smem, stream>>>(qm, km, vm, static_cast<bf16*>(o), S,
                                                    q_off, H, Hkv, B * Hkv, P, n_qtiles, window,
                                                    scale, cap);
  return cudaGetLastError();
}

template <typename T, int NCH, bool WIDE>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int S,
                   int Sk, int q_off, int H, int Hkv, int D, int window, float scale, float cap,
                   cudaStream_t stream) {
  const int Dp = WIDE ? WIDE_COLS : (D + 3) / 4 * 4;
  const size_t smem = sizeof(float) * ((size_t)BLOCK_ROWS * Dp + (size_t)BK * (Dp + 4) +
                                       (size_t)BK * Dp);
  auto kern = flash_fwd_kernel<T, NCH, WIDE>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long n_rows = (long long)S * (H / Hkv);
  const dim3 grid((unsigned)((n_rows + BLOCK_ROWS - 1) / BLOCK_ROWS), (unsigned)(B * Hkv),
                  WIDE ? (unsigned)((D + WIDE_COLS - 1) / WIDE_COLS) : 1u);
  kern<<<grid, THREADS, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                        static_cast<const T*>(v), static_cast<T*>(o), S, Sk,
                                        q_off, H, Hkv, D, Dp, window, scale, cap);
  return cudaGetLastError();
}

}  // namespace

// q: (B,Sq,H,D) at global positions q_off .. q_off + Sq - 1; k, v: (B,Sk,Hkv,D)
// at 0 .. Sk - 1, Sk >= q_off + Sq; o: (B,Sq,H,D); all contiguous, one dtype
// (0 = float32, 1 = bfloat16). window <= 0 = full causal; cap <= 0 = no cap.
// Returns the CUDA error code of the launch (0 = success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int B, int Sq, int Sk, int q_off, int H, int Hkv, int D,
                                   int window, float scale, float cap, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || q_off < 0 || Sk < q_off + Sq || Hkv <= 0 || H % Hkv != 0 ||
      D <= 0 || B * Hkv > 65535 || D > WIDE_COLS * 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ARGS q, k, v, o, B, Sq, Sk, q_off, H, Hkv
  if (dtype == 1) {
    if (D == 256) return (int)launch_wgmma<256>(ARGS, window, scale, cap, st);
    if (D == 160) return (int)launch_wgmma<160>(ARGS, window, scale, cap, st);
    if (D == 128) return (int)launch_wgmma<128>(ARGS, window, scale, cap, st);
    if (D == 112) return (int)launch_wgmma<112>(ARGS, window, scale, cap, st);
    if (D == 64) return (int)launch_wgmma<64>(ARGS, window, scale, cap, st);
  }
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
  if (D > WIDE_COLS)
    return (int)(dtype ? launch<bf, 2, true>(ARGS, D, window, scale, cap, st)
                       : launch<float, 2, true>(ARGS, D, window, scale, cap, st));
  if (D > 128)
    return (int)(dtype ? launch<bf, 2, false>(ARGS, D, window, scale, cap, st)
                       : launch<float, 2, false>(ARGS, D, window, scale, cap, st));
  return (int)(dtype ? launch<bf, 1, false>(ARGS, D, window, scale, cap, st)
                     : launch<float, 1, false>(ARGS, D, window, scale, cap, st));
#undef ARGS
}
