// flash_attention: causal or non-causal GQA attention with an online
// softmax, for Hopper (sm_90a). Two kernels, chosen by the wrapper
// (kernels/flash_attention/ops.py) by dtype and head dim:
//
//   route 1, "wgmma": bfloat16 on the tensor cores (flash_wgmma_kernel);
//   route 0, "ffma":  float32 on the float32 pipe (flash_attention_kernel).
//
// Replaces the Pallas TPU kernel `flash_attention` in
// src/repro/kernels/flash_attention/kernel.py (body `_flash_kernel`):
//
//   o[bh, i] = sum_j softmax_j(s[i, j]) * v[bh / G, j],
//   s[i, j]  = (q[bh, i] . k[bh / G, j]) * scale, masked to -1e30 where
//              key j lies past Tk or (causal) past query position
//              i + q_offset,
//
// with q [B*Hq, Tq, Dh], k/v [B*Hkv, Tk, Dh] batch-head major (G = Hq/Hkv;
// q head b*Hq + h reads kv head b*Hkv + h/G, no repeated copy), accumulated
// in float32, the output in the input type and divided by max(l, 1e-30) as
// the TPU kernel does. `scale` is Dh^-1/2 of the caller's head dim (the
// wrapper may pad the head dim with zero columns, which add 0 to q.k).
//
// What bounds it: operations. A causal call does about 2*B*Hq*Tq*Tk*Dh
// float operations on ~4*B*Hkv*Tk*Dh bytes; at granite-3-8b's prefill shape
// (Hq 32, Hkv 8, T 4096, Dh 128) that is ~2,000 operations a byte, above
// the tensor cores' ~295 and far above the float32 pipe's ~20. Only the
// tensor cores (989 TFLOP/s dense bf16) can approach the bound.
//
// The wgmma design (FlashAttention-3's shape). One 384-thread block owns
// one (batch-head, 128-query tile); blocks with the most key tiles start
// first. Warpgroup 0 is the producer: after `setmaxnreg` gives its
// registers away, one thread issues TMA loads, the Q tile once and then each
// 128-key tile of K and of V into a 2-stage shared-memory ring, each with
// its own `mbarrier` ("full"); K and V have separate "empty" barriers, so a
// K stage is refilled as soon as its S is done. Warpgroups 1 and 2 are the
// consumers, 64 query rows each:
//   S = Q K^T   wgmma m64n128k16, Q and K both from shared memory (K's
//               row-major [keys x Dh] tile is the K-major B operand);
//   softmax     on the float32 accumulator in registers: scores scaled by
//               scale*log2(e), masked to -1e30, the row max over the 4
//               lanes of a quad by shuffles, p = 2^(s - m) by ex2.approx,
//               m and l in registers;
//   O += P V    wgmma m64nDHk16, P as the register A operand (the S
//               accumulator converted to bf16 in place: its fragment
//               layout is the A operand's), V from shared memory read
//               MN-major through the transpose bit, no copy of V.
// Step j issues S_j and P_{j-1} V_{j-1} together, waits for S_j only, and
// runs the softmax of S_j while the tensor cores finish P V; O and l are
// then rescaled to the new row maxima. The two consumers take turns on the
// tensor cores through two named barriers, so one issues while the other
// runs its softmax (the exponentials alone take about half the time of the
// products at Dh = 128).
// Tiles are stored by TMA with the 128-byte swizzle (boxes of 128 rows x 64
// bf16 columns, so Dh = 128 takes two boxes a row) and read by wgmma through
// descriptors of the same swizzle; every box starts on a 1024-byte boundary.
// Key tiles run from the last (the diagonal) down to 0, so only the first
// one or two tiles of a block pay for the mask: a tile is masked where it
// crosses the diagonal of the warpgroup's rows (any q_offset) or Tk. Ragged
// Tq and Tk are never padded in memory: the 3-D tensor maps
// [heads, T, Dh] load rows past T as zeros, and rows past Tq are not
// stored. P is rounded to bf16 before P V (l sums the float32 P). A tile
// whose scores are all masked for a row gives that row p = 1 until a tile
// with an unmasked key arrives, whose rescale factor 2^(-1e30 - m) is
// exactly 0; key tile 0 always holds an unmasked key (q_offset >= 0), so a
// masked score contributes exactly 0 whatever the tiling. Head dims 64 and
// 128 only: the wrapper pads others with zero columns.
//
// The ffma design (the port's first kernel, kept for float32, where the
// JAX tests' 2e-5 rules out TF32 and bf16 products). One 256-thread block
// owns one (bh, 64-query tile) and loops over 64-key tiles itself, carrying
// m, l and the 64 x Dh accumulator in registers (FlashAttention-2's
// schedule). Per key tile: K is staged in shared memory (float32, rows
// padded to Dh+4 floats so the column reads of 16 threads fall in distinct
// banks), each thread forms a 4 x 4 block of scores (rows 4*ty.., keys
// tx + 16c), the row max and sum are reduced over the 16 threads of a row
// with shuffles, the probabilities go to shared memory, V replaces K in the
// same buffer, and each thread adds its 4 rows x Dh/16 columns of P V. Key
// tiles wholly above the diagonal are never loaded (the TPU kernel's block
// skip); blocks with the most key tiles start first. Ragged Tq and Tk are
// masked, never padded in memory: missing rows load as zeros and are not
// stored. expf, not __expf. Its bfloat16 instantiation is reachable only
// through route 0, which no main path asks for.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

// ---------------------------------------------------------------------------
// Route 0: the float32 pipe.
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr int kPStride = kBK + 4;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Stage rows [r0, r0 + rows) of a [n_rows, Dh] matrix into a [rows][DH + 4]
// float32 tile, zero past n_rows and past Dh.
template <typename T, int DH>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int64_t r0,
                                          int rows, int64_t n_rows, int Dh) {
  constexpr int S = DH + 4;
  for (int e = threadIdx.x; e < rows * DH; e += kThreads) {
    const int r = e / DH;
    const int d = e % DH;
    float x = 0.0f;
    if (r0 + r < n_rows && d < Dh) x = to_f32(src[(r0 + r) * Dh + d]);
    dst[r * S + d] = x;
  }
}

// DH: the head dim rounded up to 32, 64 or 128 (zero columns beyond Dh).
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       int64_t BHq, int64_t Tq, int64_t Tk, int Dh, int group,
                       int causal, int64_t q_offset, float scale, int n_q_tiles) {
  constexpr int S = DH + 4;
  constexpr int CPT = DH / 16;          // output columns a thread owns
  constexpr int W = CPT >= 4 ? 4 : CPT; // ... in NG groups of W adjacent columns
  constexpr int NG = CPT / W;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [kBQ][S]
  float* KV = Qs + kBQ * S;                     // [kBK][S]: K, then V
  float* Ps = KV + kBK * S;                     // [kBQ][kPStride]

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int64_t bh = blockIdx.x % BHq;
  const int qt = n_q_tiles - 1 - (int)(blockIdx.x / BHq);
  const int64_t q0 = (int64_t)qt * kBQ;
  const int64_t kvh = bh / group;
  const T* qg = q + bh * Tq * Dh;
  const T* kg = k + kvh * Tk * Dh;
  const T* vg = v + kvh * Tk * Dh;

  int64_t n_kv = (Tk + kBK - 1) / kBK;
  if (causal) {
    const int64_t last = (q0 + q_offset + kBQ - 1) / kBK;  // the TPU kernel's block_needed
    n_kv = n_kv < last + 1 ? n_kv : last + 1;
  }

  load_tile<T, DH>(Qs, qg, q0, kBQ, Tq, Dh);

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[r][c] = 0.0f;
  }

  for (int64_t kt = 0; kt < n_kv; ++kt) {
    const int64_t k0 = kt * kBK;
    __syncthreads();  // the last tile's P V is done with KV
    load_tile<T, DH>(KV, kg, k0, kBK, Tk, Dh);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qa[r] = *reinterpret_cast<const float4*>(Qs + (ty * 4 + r) * S + d);
#pragma unroll
      for (int c = 0; c < 4; ++c) kb[c] = *reinterpret_cast<const float4*>(KV + (tx + 16 * c) * S + d);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float x = s[r][c];
          x = fmaf(qa[r].x, kb[c].x, x);
          x = fmaf(qa[r].y, kb[c].y, x);
          x = fmaf(qa[r].z, kb[c].z, x);
          x = fmaf(qa[r].w, kb[c].w, x);
          s[r][c] = x;
        }
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int64_t qpos = q0 + ty * 4 + r + q_offset;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int64_t kpos = k0 + tx + 16 * c;
        const bool valid = kpos < Tk && (!causal || kpos <= qpos);
        s[r][c] = valid ? s[r][c] * scale : kNegInf;
        mx = fmaxf(mx, s[r][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float corr = expf(m[r] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[r][c] - m_new);
        Ps[(ty * 4 + r) * kPStride + tx + 16 * c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[r] = l[r] * corr + sum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[r][c] *= corr;
    }
    __syncthreads();  // every thread is done reading K; P is complete
    load_tile<T, DH>(KV, vg, k0, kBK, Tk, Dh);
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float4 pr[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) pr[r] = *reinterpret_cast<const float4*>(Ps + (ty * 4 + r) * kPStride + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vv[CPT];
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const float* src = KV + (j + jj) * S + g * 16 * W + tx * W;
          if constexpr (W == 4) {
            const float4 t = *reinterpret_cast<const float4*>(src);
            vv[g * 4 + 0] = t.x; vv[g * 4 + 1] = t.y; vv[g * 4 + 2] = t.z; vv[g * 4 + 3] = t.w;
          } else {
            const float2 t = *reinterpret_cast<const float2*>(src);
            vv[g * 2 + 0] = t.x; vv[g * 2 + 1] = t.y;
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float p = jj == 0 ? pr[r].x : jj == 1 ? pr[r].y : jj == 2 ? pr[r].z : pr[r].w;
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[r][c] = fmaf(p, vv[c], acc[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int64_t row = q0 + ty * 4 + r;
    if (row >= Tq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    T* orow = o + (bh * Tq + row) * Dh;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int i = 0; i < W; ++i) {
        const int col = g * 16 * W + tx * W + i;
        if (col < Dh) store(orow + col, acc[r][g * W + i] / denom);
      }
  }
}

template <typename T, int DH>
int ffma_launch(const void* q, const void* k, const void* v, void* o, long long BHq, long long BHkv,
           long long Tq, long long Tk, int Dh, int causal, long long q_offset, float scale,
           cudaStream_t stream) {
  constexpr int S = DH + 4;
  constexpr int smem = (kBQ * S + kBK * S + kBQ * kPStride) * (int)sizeof(float);
  auto kernel = flash_attention_kernel<T, DH>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long n_q_tiles = (Tq + kBQ - 1) / kBQ;
  const long long blocks = n_q_tiles * BHq;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, BHq, Tq, Tk, Dh, (int)(BHq / BHkv),
      causal, q_offset, scale, (int)n_q_tiles);
  return (int)cudaGetLastError();
}

template <typename T>
int ffma_launch_dh(const void* q, const void* k, const void* v, void* o, long long BHq, long long BHkv,
              long long Tq, long long Tk, long long Dh, int causal, long long q_offset,
              float scale, cudaStream_t s) {
  const int dh = (int)Dh;
  if (Dh <= 32) return ffma_launch<T, 32>(q, k, v, o, BHq, BHkv, Tq, Tk, dh, causal, q_offset, scale, s);
  if (Dh <= 64) return ffma_launch<T, 64>(q, k, v, o, BHq, BHkv, Tq, Tk, dh, causal, q_offset, scale, s);
  if (Dh <= 128) return ffma_launch<T, 128>(q, k, v, o, BHq, BHkv, Tq, Tk, dh, causal, q_offset, scale, s);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Route 1: bfloat16 on the tensor cores.
// ---------------------------------------------------------------------------

constexpr int kWBQ = 128;                   // query rows a block owns
constexpr int kWBK = 128;                   // keys a tile
constexpr int kWThreads = 384;              // producer warpgroup + 2 consumers
constexpr int kBoxBytes = 128 * 64 * 2;     // one [128 rows x 64 bf16] box
constexpr int kStages = 2;
constexpr int kMaxDevices = 64;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One box of a 3-D tensor map (coordinates innermost first) into shared
// memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a tile stored with the 128-byte swizzle:
// start address, leading and stride byte offsets (in 16-byte units), layout
// type 1 (128B swizzle) in bits 62-63. Rows are 128 bytes; groups of 8 rows
// are 1024 bytes apart (the stride byte offset).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo_bytes) {
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)(1024 >> 4) << 32;
  d |= (uint64_t)1 << 62;
  return d;
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wg_wait() { asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory"); }

// Keep the compiler from touching an accumulator or operand register across
// an asynchronous wgmma: reads after the wait, writes before the fence.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// d[64] (+)= A[64 x 16] * B[16 x 128], A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                    int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
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
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[32] += A[64 x 16] * B[16 x 64], A in registers (bf16 pairs), B MN-major
// in shared memory (transpose bit set).
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

__device__ __forceinline__ void wgmma_rs_m64n128k16(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n"
      "}\n"
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
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// 2^x by the special-function unit alone (ex2.approx: about 2 ulp; the
// output is bf16). exp2f adds range checks to every call.
__device__ __forceinline__ float exp2_(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Named barriers 1 and 2 (256 threads: both consumer warpgroups) take
// turns between the consumers, so that one issues its products while the
// other runs its softmax.
__device__ __forceinline__ void named_sync(int id) { asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory"); }
__device__ __forceinline__ void named_arrive(int id) { asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory"); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

// S[64 x 128] = Q[64 x DH] K[128 x DH]^T, both K-major in swizzled boxes.
template <int DH>
__device__ __forceinline__ void issue_s(float (&sc)[64], uint32_t q_addr, uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const uint32_t off = (kk >> 2) * kBoxBytes + (kk & 3) * 32;
    wgmma_ss_m64n128k16(sc, sw128_desc(q_addr + off, 16), sw128_desc(k_addr + off, 16), kk > 0);
  }
}

// O[64 x DH] += P[64 x 128] V[128 x DH], P in registers, V MN-major (the
// transpose bit): one m64nDHk16 per 16 keys. The stride byte offset (1024)
// steps 8 keys; at DH = 128 the leading byte offset steps from the first
// 64-column box to the second.
template <int DH>
__device__ __forceinline__ void issue_pv(float (&acc)[DH / 2], const uint32_t (&pa)[kWBK / 16][4],
                                         uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < kWBK / 16; ++kk) {
    const uint32_t vrow = v_addr + kk * 16 * 128;
    if constexpr (DH == 128) {
      wgmma_rs_m64n128k16(acc, pa[kk], sw128_desc(vrow, kBoxBytes));
    } else {
      wgmma_rs_m64n64k16(acc, pa[kk], sw128_desc(vrow, kBoxBytes));
    }
  }
}

// One tile of scores in the m64n128 accumulator layout (register 4i + e of
// a thread is row r0 + 8*(e >> 1), key 8i + 2*(lane & 3) + (e & 1)): scale
// to log2 units, mask, update the row maxima m (shared by the quad's four
// lanes), and replace the scores by p = exp2(s - m) in place. Returns the
// rescale factors of the old maxima and the thread's partial row sums.
__device__ __forceinline__ void softmax_tile(float (&sc)[64], float& m0, float& m1, float& corr0,
                                             float& corr1, float& ls0, float& ls1, bool masked, int k0,
                                             int Tk, int causal, int qpos0, int lane, float scale_log2) {
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = sc[4 * i + e] * scale_log2;
      if (masked) {
        const int key = k0 + 8 * i + 2 * (lane & 3) + (e & 1);
        const int qpos = qpos0 + 4 * (e & 2);
        if (key >= Tk || (causal && key > qpos)) x = kNegInf;
      }
      sc[4 * i + e] = x;
      if (e & 2) mx1 = fmaxf(mx1, x); else mx0 = fmaxf(mx0, x);
    }
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  corr0 = exp2_(m0 - mn0);
  corr1 = exp2_(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  ls0 = 0.0f;
  ls1 = 0.0f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    sc[4 * i + 0] = exp2_(sc[4 * i + 0] - mn0);
    sc[4 * i + 1] = exp2_(sc[4 * i + 1] - mn0);
    sc[4 * i + 2] = exp2_(sc[4 * i + 2] - mn1);
    sc[4 * i + 3] = exp2_(sc[4 * i + 3] - mn1);
    ls0 += sc[4 * i + 0] + sc[4 * i + 1];
    ls1 += sc[4 * i + 2] + sc[4 * i + 3];
  }
}

// P (float32, accumulator layout) -> the bf16 A operand of P V: n8 chunk i
// of keys 8i..8i+7 gives registers 0 (row) and 1 (row + 8) of k-step i/2
// when i is even, registers 2 and 3 when i is odd.
__device__ __forceinline__ void to_bf16(const float (&sc)[64], uint32_t (&pa)[kWBK / 16][4]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    pa[i >> 1][(i & 1) * 2 + 0] = pack_bf16(sc[4 * i + 0], sc[4 * i + 1]);
    pa[i >> 1][(i & 1) * 2 + 1] = pack_bf16(sc[4 * i + 2], sc[4 * i + 3]);
  }
}

// DH: 64 or 128, the head dim of the arrays (a multiple of the 64-column box).
template <int DH>
__global__ void __launch_bounds__(kWThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tmap_q, const __grid_constant__ CUtensorMap tmap_k,
                   const __grid_constant__ CUtensorMap tmap_v, __nv_bfloat16* __restrict__ o,
                   int BHq, int Tq, int Tk, int group, int causal, int q_offset, float scale_log2,
                   int n_q_tiles) {
  constexpr int NB = DH / 64;  // boxes a row
  extern __shared__ uint8_t wgmma_smem[];
  const uint32_t raw = smem_u32(wgmma_smem);
  const uint32_t sq = (raw + 1023u) & ~1023u;         // Q: NB boxes
  const uint32_t sk = sq + NB * kBoxBytes;            // K: [kStages][NB] boxes
  const uint32_t sv = sk + kStages * NB * kBoxBytes;  // V: [kStages][NB] boxes
  const uint32_t bars = sv + kStages * NB * kBoxBytes;
  const uint32_t bar_q = bars;
  auto bar_k = [&](int s) { return bars + 8u * (1 + s); };
  auto bar_v = [&](int s) { return bars + 8u * (1 + kStages + s); };
  auto bar_k_empty = [&](int s) { return bars + 8u * (1 + 2 * kStages + s); };
  auto bar_v_empty = [&](int s) { return bars + 8u * (1 + 3 * kStages + s); };

  const int bh = (int)(blockIdx.x % (unsigned)BHq);
  const int qt = n_q_tiles - 1 - (int)(blockIdx.x / (unsigned)BHq);
  const int q0 = qt * kWBQ;
  const int kvh = bh / group;
  int n_kv = (Tk + kWBK - 1) / kWBK;
  if (causal) {
    const int last = (q0 + q_offset + kWBQ - 1) / kWBK;
    n_kv = n_kv < last + 1 ? n_kv : last + 1;
  }

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_k(s), 1);
      mbar_init(bar_v(s), 1);
      mbar_init(bar_k_empty(s), 8);  // one arrival per consumer warp
      mbar_init(bar_v_empty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, NB * kBoxBytes);
      for (int c = 0; c < NB; ++c) tma_load_3d(sq + c * kBoxBytes, &tmap_q, bar_q, c * 64, q0, bh);
      for (int it = 0; it < n_kv; ++it) {
        const int kt = n_kv - 1 - it;
        const int s = it % kStages;
        const uint32_t reuse = ((it / kStages) - 1) & 1;  // phase of the release of tile it - kStages
        if (it >= kStages) mbar_wait(bar_k_empty(s), reuse);
        mbar_expect_tx(bar_k(s), NB * kBoxBytes);
        for (int c = 0; c < NB; ++c)
          tma_load_3d(sk + (s * NB + c) * kBoxBytes, &tmap_k, bar_k(s), c * 64, kt * kWBK, kvh);
        if (it >= kStages) mbar_wait(bar_v_empty(s), reuse);
        mbar_expect_tx(bar_v(s), NB * kBoxBytes);
        for (int c = 0; c < NB; ++c)
          tma_load_3d(sv + (s * NB + c) * kBoxBytes, &tmap_v, bar_v(s), c * 64, kt * kWBK, kvh);
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1;
    const int tid = threadIdx.x & 127;
    const int lane = tid & 31;
    const int r0 = cw * 64 + (tid >> 5) * 16 + (lane >> 2);  // the thread's rows: r0 and r0 + 8
    const int qpos0 = q0 + r0 + q_offset;
    const int wg_first = q0 + cw * 64 + q_offset;  // position of the warpgroup's first row
    const uint32_t sq_wg = sq + cw * 64 * 128;     // its 64 rows of each Q box

    float acc[DH / 2], sc[64];
    uint32_t pa[kWBK / 16][4];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < 64; ++i) sc[i] = 0.0f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;
    float corr0, corr1, ls0, ls1;
    auto probabilities = [&](int it) {  // S of step it -> P in place
      const int k0 = (n_kv - 1 - it) * kWBK;
      const bool masked = k0 + kWBK > Tk || (causal && k0 + kWBK - 1 > wg_first);
      softmax_tile(sc, m0, m1, corr0, corr1, ls0, ls1, masked, k0, Tk, causal, qpos0, lane, scale_log2);
    };

    // Turns on the tensor cores: consumer 0 holds the first, and each hands
    // the next to the other after issuing its products (both take n_kv + 1
    // turns; consumer 1 does not hand on its last).
    if (cw == 0) named_arrive(1);
    // Step 0 (the last key tile): S, then P; nothing to add into O yet.
    mbar_wait(bar_q, 0);
    mbar_wait(bar_k(0), 0);
    reg_fence(sc);
    named_sync(1 + cw);
    wg_fence();
    issue_s<DH>(sc, sq_wg, sk);
    wg_commit();
    named_arrive(2 - cw);
    wg_wait<0>();
    reg_fence(sc);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_k_empty(0));
    probabilities(0);
    l0 = ls0;
    l1 = ls1;
    to_bf16(sc, pa);

    // Step it issues S = Q K_it^T and O += P_{it-1} V_{it-1} together; the
    // softmax of S runs while the tensor cores finish P V.
    for (int it = 1; it < n_kv; ++it) {
      const int s = it % kStages, sp = (it - 1) % kStages;
      mbar_wait(bar_k(s), (it / kStages) & 1);
      mbar_wait(bar_v(sp), ((it - 1) / kStages) & 1);
      reg_fence(sc);
      reg_fence(acc);
      reg_fence(pa);
      named_sync(1 + cw);
      wg_fence();
      issue_s<DH>(sc, sq_wg, sk + s * NB * kBoxBytes);
      wg_commit();
      issue_pv<DH>(acc, pa, sv + sp * NB * kBoxBytes);
      wg_commit();
      named_arrive(2 - cw);
      wg_wait<1>();  // S is done; P V may still run
      reg_fence(sc);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_k_empty(s));
      probabilities(it);
      wg_wait<0>();
      reg_fence(acc);
      reg_fence(pa);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_v_empty(sp));
      l0 = l0 * corr0 + ls0;
      l1 = l1 * corr1 + ls1;
#pragma unroll
      for (int i = 0; i < DH / 8; ++i) {
        acc[4 * i + 0] *= corr0;
        acc[4 * i + 1] *= corr0;
        acc[4 * i + 2] *= corr1;
        acc[4 * i + 3] *= corr1;
      }
      to_bf16(sc, pa);
    }

    // P V of the last step.
    const int sl = (n_kv - 1) % kStages;
    mbar_wait(bar_v(sl), ((n_kv - 1) / kStages) & 1);
    reg_fence(acc);
    reg_fence(pa);
    named_sync(1 + cw);
    wg_fence();
    issue_pv<DH>(acc, pa, sv + sl * NB * kBoxBytes);
    wg_commit();
    if (cw == 0) named_arrive(2);
    wg_wait<0>();
    reg_fence(acc);
    reg_fence(pa);

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.0f / fmaxf(l0, 1e-30f), inv1 = 1.0f / fmaxf(l1, 1e-30f);
    const int row0 = q0 + r0, row1 = row0 + 8;
    __nv_bfloat16* ob = o + (size_t)bh * Tq * DH;
#pragma unroll
    for (int i = 0; i < DH / 8; ++i) {
      const int col = 8 * i + 2 * (lane & 3);
      if (row0 < Tq)
        *reinterpret_cast<uint32_t*>(ob + (size_t)row0 * DH + col) =
            pack_bf16(acc[4 * i + 0] * inv0, acc[4 * i + 1] * inv0);
      if (row1 < Tq)
        *reinterpret_cast<uint32_t*>(ob + (size_t)row1 * DH + col) =
            pack_bf16(acc[4 * i + 2] * inv1, acc[4 * i + 3] * inv1);
    }
  }
}

// cuTensorMapEncodeTiled from the driver, found through the runtime so that
// the library needs no -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &status);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (err == cudaSuccess && status == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)p;
  }
  return fn;
}

// A [heads, rows, dh] bf16 array as a 3-D tensor map of [128 x 64] boxes,
// 128-byte swizzle, rows past `rows` read as zeros.
bool make_tensor_map(CUtensorMap* map, const void* ptr, int dh, long long rows, long long heads) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)dh, (cuuint64_t)rows, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)dh * 2, (cuuint64_t)(rows * dh * 2)};
  const cuuint32_t box[3] = {64, 128, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH>
int wgmma_launch(const void* q, const void* k, const void* v, void* o, long long BHq, long long BHkv,
                 long long Tq, long long Tk, int causal, long long q_offset, float scale,
                 cudaStream_t stream) {
  constexpr int smem = 1024 + (1 + 2 * kStages) * (DH / 64) * kBoxBytes + 8 * (1 + 4 * kStages);
  alignas(64) CUtensorMap mq, mk, mv;
  if (!make_tensor_map(&mq, q, DH, Tq, BHq) || !make_tensor_map(&mk, k, DH, Tk, BHkv) ||
      !make_tensor_map(&mv, v, DH, Tk, BHkv))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_wgmma_kernel<DH>;
  // The shared-memory cap lasts for the process: raise it once a device,
  // not on every launch.
  static std::atomic<bool> smem_set[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!smem_set[dev].load(std::memory_order_relaxed)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev].store(true, std::memory_order_relaxed);
  }
  const long long n_q_tiles = (Tq + kWBQ - 1) / kWBQ;
  const long long blocks = n_q_tiles * BHq;
  if (blocks > 0x7fffffffLL || Tq + q_offset + kWBQ > 0x7fffffffLL || Tk > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, kWThreads, smem, stream>>>(
      mq, mk, mv, (__nv_bfloat16*)o, (int)BHq, (int)Tq, (int)Tk, (int)(BHq / BHkv), causal,
      (int)q_offset, scale * kLog2e, (int)n_q_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. route: 0 = ffma (either dtype, Dh 1..128),
// 1 = wgmma (bfloat16, Dh 64 or 128, 16-byte aligned arrays). `scale`
// multiplies q.k. Returns the CUDA error of the launch.
int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                           long long BHq, long long BHkv, long long Tq, long long Tk,
                           long long Dh, int causal, long long q_offset, float scale,
                           int dtype, int route, void* stream) {
  if (BHq == 0 || Tq == 0) return (int)cudaGetLastError();
  if (BHkv <= 0 || BHq % BHkv != 0 || Tk <= 0 || q_offset < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (route == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    if (Dh == 64) return wgmma_launch<64>(q, k, v, o, BHq, BHkv, Tq, Tk, causal, q_offset, scale, s);
    if (Dh == 128) return wgmma_launch<128>(q, k, v, o, BHq, BHkv, Tq, Tk, causal, q_offset, scale, s);
    return (int)cudaErrorInvalidValue;
  }
  if (route != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return ffma_launch_dh<float>(q, k, v, o, BHq, BHkv, Tq, Tk, Dh, causal, q_offset, scale, s);
  if (dtype == 1)
    return ffma_launch_dh<__nv_bfloat16>(q, k, v, o, BHq, BHkv, Tq, Tk, Dh, causal, q_offset, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
