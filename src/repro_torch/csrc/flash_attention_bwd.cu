// flash_attention_bwd: the backward of flash_attention (csrc/flash_attention.cu)
// for Hopper (sm_90a), FlashAttention-2's deterministic two-pass scheme.
//
// Replaces no Pallas kernel: the JAX package has no Pallas backward and
// differentiates its oracle, so this computes what jax.grad of
// attention_ref (src/repro/kernels/flash_attention/ref.py) computes:
//
//   P  = exp(S * scale - lse),  S = Q K^T, masked entries P = 0,
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - Delta),  Delta = rowsum(dO o O),
//   dQ = dS K * scale,  dK = dS^T Q * scale,
//
// with q/o/dO [B*Hq, Tq, Dh], k/v [B*Hkv, Tk, Dh] batch-head major (q head
// bh reads kv head bh / G, G = Hq/Hkv) and lse [B*Hq, Tq] float32 from the
// forward (natural log). A kv head's dK and dV are the sums over its G q
// heads. Masked: keys past Tk, rows past Tq and (causal) keys past the query
// position i + q_offset; they are loaded as zeros and their P is forced to
// exactly 0, never exp(0 - garbage).
//
// One call is three launches on the caller's stream:
//   a. Delta = rowsum(dO o O) in float32 ([B*Hq, Tq], scratch from the wrapper);
//   b. the dK/dV pass: one block per (kv head, key tile); it loops over the
//      G q heads of the group and, for each, over the query tiles that the
//      mask lets see the tile, recomputes S and P, and accumulates dV and
//      dK in float32 registers; each of dk and dv is written once, so the
//      group sum needs no atomics;
//   c. the dQ pass: one block per (q head, query tile); it loops over the
//      visible key tiles, recomputes S, P and dP, and accumulates dQ in
//      registers; dq is written once.
// Every sum runs in a fixed order, so two calls give the same bits. The two
// passes do 14 * Hq * pairs * Dh operations (S and dP twice) against the 10
// of one pass with atomic dQ: the price of repeatable gradients.
//
// What bounds it: operations. The four products the gradient needs are 8 *
// Hq * pairs * Dh operations on ~4 * (Hq + Hkv) * Tk * Dh * 2 bytes; at
// granite-3-8b's prefill shape (Hq 32, Hkv 8, T 4096, Dh 128, causal) that
// is 274.9 GFLOP on 84 MB, far above the tensor cores' ~295 operations a byte.
//
// Route 1, "mma" (bfloat16): every product on the tensor cores by warp-level
// mma.sync.m16n8k16 (bf16 in, float32 accumulate). 256-thread blocks of 8
// warps, each warp owning 16 rows of the block's tile: in pass b 16 keys of
// a 128-key tile (dK and dV [16 x Dh] in its registers), in pass c 16 queries
// of a 128-query tile. Tiles of 64 rows of the other side stream through a
// 2-stage shared-memory ring by cp.async (zero-filled past Tq or Tk); rows
// are padded by 16 bytes so that ldmatrix's eight row addresses fall in eight
// distinct bank groups. Fragments come from shared memory by ldmatrix: the
// B operands Q^T, dO^T, K^T and V^T of S and dP directly (rows of the stored
// tiles are their columns), Q, dO and K as the B operands of dK, dV and dQ
// through ldmatrix.trans. P^T and dS^T (pass b), and dS (pass c), go from
// the float32 accumulator straight to the bf16 A operand in registers (the
// m16n8 accumulator layout of two n-tiles is the m16k16 A layout), rounded
// to bf16 as the forward rounds P. P = 2^(S * scale * log2 e - lse * log2 e)
// by ex2.approx. Head dims 64 and 128; the wrapper zero-pads others.
//
// Route 0, "ffma" (float32): the same two passes on the float32 pipe (the
// JAX tests' float32 bars rule out TF32), the forward's ffma layout: 256
// threads as 16 x 16, each a 4 x 4 block of a 64 x 64 score tile, rows of the
// staged tiles padded to Dh + 4 floats; P^T and dS^T (pass b) or dS (pass c)
// go through shared memory to the products that reduce over the tile. Any
// head dim 1..128 (zero columns beyond it). expf, not __expf.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// ---------------------------------------------------------------------------
// a. Delta = rowsum(dO o O): one warp a row.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(256)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
             int64_t rows, int Dh) {
  const int64_t row = (int64_t)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warps leave together
  const T* orow = o + row * Dh;
  const T* drow = dout + row * Dh;
  float s = 0.0f;
  for (int d = lane; d < Dh; d += 32) s = fmaf(to_f32(orow[d]), to_f32(drow[d]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

template <typename T>
int delta_launch(const void* o, const void* dout, float* delta, long long rows, long long Dh,
                 cudaStream_t stream) {
  if (rows == 0) return (int)cudaSuccess;
  const long long blocks = (rows + 7) / 8;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  delta_kernel<T><<<(unsigned)blocks, 256, 0, stream>>>((const T*)o, (const T*)dout, delta, rows, (int)Dh);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Route 1: bfloat16 on the tensor cores (mma.sync).
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;

constexpr int kMThreads = 256;  // 8 warps, 16 rows of the block's tile each
constexpr int kKV = 128;        // keys a dK/dV block
constexpr int kQI = 64;         // queries a step of the dK/dV block
constexpr int kQB = 128;        // queries a dQ block
constexpr int kKI = 64;         // keys a step of the dQ block
constexpr int kPad = 8;         // bf16 elements of padding a staged row (16 bytes)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, zero-filled when !valid (src is then not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d[16 x 8] += a[16 x 16] b[16 x 8], bf16 in, float32 accumulate.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

__device__ __forceinline__ float exp2_(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Shared-memory address a lane hands ldmatrix.x4 for the 16 x 16 block at
// (r0, c0) of a tile with RS-element rows: lanes 0-15 rows r0..r0+15 at c0,
// lanes 16-31 the same rows at c0 + 8. It gives the A operand of rows
// r0.. and columns c0.. (non-transposed), and through .trans the B operands
// of two n8 tiles (columns c0.. and c0 + 8..) over k rows r0.. of a tile
// stored [k][n].
template <int RS>
__device__ __forceinline__ uint32_t addr_a(uint32_t base, int r0, int c0, int lane) {
  return base + ((r0 + (lane & 15)) * RS + c0 + (lane >> 4) * 8) * 2;
}
// ... and the B operands of two n8 tiles (rows n0.. and n0 + 8.. of a tile
// stored [n][k]) over columns k0..k0+15, non-transposed.
template <int RS>
__device__ __forceinline__ uint32_t addr_b(uint32_t base, int n0, int k0, int lane) {
  return base + ((n0 + (lane & 7) + ((lane >> 4) << 3)) * RS + k0 + ((lane >> 3) & 1) * 8) * 2;
}

// Rows [r0, r0 + ROWS) of a [n_rows, DH] bf16 matrix into a [ROWS][DH + kPad]
// shared tile; rows past n_rows are zero-filled.
template <int DH, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* __restrict__ src, int r0, int n_rows) {
  constexpr int CH = DH / 8;
  for (int e = threadIdx.x; e < ROWS * CH; e += kMThreads) {
    const int r = e / CH, c = e % CH;
    const bool ok = r0 + r < n_rows;
    cp_async16(dst + (r * (DH + kPad) + c * 8) * 2, src + (size_t)(ok ? r0 + r : 0) * DH + c * 8, ok);
  }
}

__device__ __forceinline__ void load_vec(uint32_t dst, const float* __restrict__ src, int r0, int n, int count) {
  for (int i = threadIdx.x; i < count; i += kMThreads) {
    const bool ok = r0 + i < n;
    cp_async4(dst + 4 * i, src + (ok ? r0 + i : 0), ok);
  }
}

// acc[16 x 64] = A[16 rows at a_row of a, DH] B^T, B the 64 rows of b ([n][k]).
template <int DH>
__device__ __forceinline__ void product_nt(float (&acc)[8][4], uint32_t a, int a_row, uint32_t b, int lane) {
  constexpr int RS = DH + kPad;
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    uint32_t fa[4];
    ldsm_x4(fa, addr_a<RS>(a, a_row, 16 * kk, lane));
#pragma unroll
    for (int t2 = 0; t2 < 4; ++t2) {
      uint32_t fb[4];
      ldsm_x4(fb, addr_b<RS>(b, 16 * t2, 16 * kk, lane));
      mma16816(acc[2 * t2], fa, fb[0], fb[1]);
      mma16816(acc[2 * t2 + 1], fa, fb[2], fb[3]);
    }
  }
}

// acc[16 x DH] += X[16 x 64] B, X in the accumulator layout (rounded to bf16
// as the A operand), B the 64 x DH tile b stored [k][n].
template <int DH>
__device__ __forceinline__ void product_acc(float (&acc)[DH / 8][4], const float (&x)[8][4], uint32_t b, int lane) {
  constexpr int RS = DH + kPad;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t fa[4] = {pack_bf16(x[2 * kk][0], x[2 * kk][1]), pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                            pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                            pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int n2 = 0; n2 < DH / 16; ++n2) {
      uint32_t fb[4];
      ldsm_x4_t(fb, addr_a<RS>(b, 16 * kk, 16 * n2, lane));
      mma16816(acc[2 * n2], fa, fb[0], fb[1]);
      mma16816(acc[2 * n2 + 1], fa, fb[2], fb[3]);
    }
  }
}

// b. dK/dV: block (kv head kvh, key tile kt); warp w owns keys 16w..16w+15
// of the tile. Register e of n-tile t of a [16 keys x 64 queries] tile is key
// (lane >> 2) + 8 (e >> 1), query 8t + 2 (lane & 3) + (e & 1).
template <int DH>
__global__ void __launch_bounds__(kMThreads, 1)
dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
                bf16* __restrict__ dk, bf16* __restrict__ dv, int BHkv, int Tq, int Tk, int group, int causal,
                int q_offset, float scale) {
  constexpr int RS = DH + kPad;
  constexpr int NT = DH / 8;
  extern __shared__ __align__(16) uint8_t mma_smem[];
  bf16* Ks = reinterpret_cast<bf16*>(mma_smem);  // [kKV][RS]
  bf16* Vs = Ks + kKV * RS;                      // [kKV][RS]
  bf16* Qs = Vs + kKV * RS;                      // [2][kQI][RS]
  bf16* Os = Qs + 2 * kQI * RS;                  // [2][kQI][RS]: dO
  float* Ls = reinterpret_cast<float*>(Os + 2 * kQI * RS);  // [2][kQI]: lse
  float* Ds = Ls + 2 * kQI;                                 // [2][kQI]: Delta

  const int kvh = (int)(blockIdx.x % (unsigned)BHkv);
  const int k0 = (int)(blockIdx.x / (unsigned)BHkv) * kKV;  // key tile 0 (the most query tiles) first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int first_qt = causal && k0 > q_offset ? (k0 - q_offset) / kQI : 0;
  const int n_qt = (Tq + kQI - 1) / kQI;
  const int n_vis = n_qt > first_qt ? n_qt - first_qt : 0;
  const int n_it = group * n_vis;

  auto prefetch = [&](int it) {
    const int bh = kvh * group + it / n_vis;
    const int q0 = (first_qt + it % n_vis) * kQI;
    const int st = it & 1;
    load_tile<DH, kQI>(smem_u32(Qs + st * kQI * RS), q + (size_t)bh * Tq * DH, q0, Tq);
    load_tile<DH, kQI>(smem_u32(Os + st * kQI * RS), dout + (size_t)bh * Tq * DH, q0, Tq);
    load_vec(smem_u32(Ls + st * kQI), lse + (size_t)bh * Tq, q0, Tq, kQI);
    load_vec(smem_u32(Ds + st * kQI), delta + (size_t)bh * Tq, q0, Tq, kQI);
  };
  if (n_it > 0) {
    load_tile<DH, kKV>(smem_u32(Ks), k + (size_t)kvh * Tk * DH, k0, Tk);
    load_tile<DH, kKV>(smem_u32(Vs), v + (size_t)kvh * Tk * DH, k0, Tk);
    prefetch(0);
  }
  cp_commit();

  float dka[NT][4], dva[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[t][e] = dva[t][e] = 0.0f;
  const int kw = warp * 16;
  const int key0 = k0 + kw + (lane >> 2);  // the thread's keys: key0 and key0 + 8
  const float scale_log2 = scale * kLog2e;
  const uint32_t ks = smem_u32(Ks), vs = smem_u32(Vs);

  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) prefetch(it + 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const int st = it & 1;
    const int q0 = (first_qt + it % n_vis) * kQI;
    const uint32_t qs = smem_u32(Qs + st * kQI * RS), os = smem_u32(Os + st * kQI * RS);
    const float* L = Ls + st * kQI;
    const float* D = Ds + st * kQI;
    const bool full = q0 + kQI <= Tq && k0 + kKV <= Tk && (!causal || k0 + kKV - 1 <= q0 + q_offset);

    float sp[8][4];  // S^T, then P^T
    product_nt<DH>(sp, ks, kw, qs, lane);
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = 8 * t + 2 * (lane & 3) + (e & 1);
        const int key = key0 + 8 * (e >> 1);
        const bool ok = full || (key < Tk && q0 + qi < Tq && (!causal || key <= q0 + qi + q_offset));
        sp[t][e] = ok ? exp2_(fmaf(sp[t][e], scale_log2, -L[qi] * kLog2e)) : 0.0f;
      }
    product_acc<DH>(dva, sp, os, lane);  // dV += P^T dO

    float ds[8][4];  // dP^T, then dS^T
    product_nt<DH>(ds, vs, kw, os, lane);
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[t][e] = sp[t][e] * (ds[t][e] - D[8 * t + 2 * (lane & 3) + (e & 1)]);
    product_acc<DH>(dka, ds, qs, lane);  // dK += dS^T Q
    __syncthreads();  // every warp is done with stage st before it is refilled
  }
  cp_wait<0>();

  bf16* dkb = dk + (size_t)kvh * Tk * DH;
  bf16* dvb = dv + (size_t)kvh * Tk * DH;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int col = 8 * t + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = key0 + 8 * h;
      if (key < Tk) {
        *reinterpret_cast<uint32_t*>(dkb + (size_t)key * DH + col) =
            pack_bf16(dka[t][2 * h] * scale, dka[t][2 * h + 1] * scale);
        *reinterpret_cast<uint32_t*>(dvb + (size_t)key * DH + col) = pack_bf16(dva[t][2 * h], dva[t][2 * h + 1]);
      }
    }
  }
}

// c. dQ: block (q head bh, query tile qt); warp w owns queries 16w..16w+15.
// Register e of n-tile t of a [16 queries x 64 keys] tile is query
// (lane >> 2) + 8 (e >> 1), key 8t + 2 (lane & 3) + (e & 1).
template <int DH>
__global__ void __launch_bounds__(kMThreads, 1)
dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
              const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dq, int BHq, int Tq, int Tk, int group, int causal, int q_offset, float scale,
              int n_q_tiles) {
  constexpr int RS = DH + kPad;
  constexpr int NT = DH / 8;
  extern __shared__ __align__(16) uint8_t mma_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(mma_smem);  // [kQB][RS]
  bf16* Os = Qs + kQB * RS;                      // [kQB][RS]: dO
  bf16* Ks = Os + kQB * RS;                      // [2][kKI][RS]
  bf16* Vs = Ks + 2 * kKI * RS;                  // [2][kKI][RS]

  const int bh = (int)(blockIdx.x % (unsigned)BHq);
  const int q0 = (n_q_tiles - 1 - (int)(blockIdx.x / (unsigned)BHq)) * kQB;  // most key tiles first
  const int kvh = bh / group;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int n_kv = (Tk + kKI - 1) / kKI;
  if (causal) {
    const int last = (q0 + kQB - 1 + q_offset) / kKI;
    n_kv = n_kv < last + 1 ? n_kv : last + 1;
  }
  const bf16* kg = k + (size_t)kvh * Tk * DH;
  const bf16* vg = v + (size_t)kvh * Tk * DH;
  auto prefetch = [&](int j) {
    const int st = j & 1;
    load_tile<DH, kKI>(smem_u32(Ks + st * kKI * RS), kg, j * kKI, Tk);
    load_tile<DH, kKI>(smem_u32(Vs + st * kKI * RS), vg, j * kKI, Tk);
  };
  load_tile<DH, kQB>(smem_u32(Qs), q + (size_t)bh * Tq * DH, q0, Tq);
  load_tile<DH, kQB>(smem_u32(Os), dout + (size_t)bh * Tq * DH, q0, Tq);
  prefetch(0);
  cp_commit();

  const int qw = warp * 16;
  const int row0 = q0 + qw + (lane >> 2);  // the thread's rows: row0 and row0 + 8
  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    lse2[h] = row < Tq ? lse[(size_t)bh * Tq + row] * kLog2e : 0.0f;
    dl[h] = row < Tq ? delta[(size_t)bh * Tq + row] : 0.0f;
  }
  float dqa[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[t][e] = 0.0f;
  const float scale_log2 = scale * kLog2e;
  const uint32_t qs = smem_u32(Qs), os = smem_u32(Os);

  for (int j = 0; j < n_kv; ++j) {
    if (j + 1 < n_kv) prefetch(j + 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const int st = j & 1;
    const int k0 = j * kKI;
    const uint32_t ks = smem_u32(Ks + st * kKI * RS), vs = smem_u32(Vs + st * kKI * RS);
    const bool full = q0 + kQB <= Tq && k0 + kKI <= Tk && (!causal || k0 + kKI - 1 <= q0 + q_offset);

    float sp[8][4];  // S, then P
    product_nt<DH>(sp, qs, qw, ks, lane);
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * t + 2 * (lane & 3) + (e & 1);
        const int row = row0 + 8 * (e >> 1);
        const bool ok = full || (key < Tk && row < Tq && (!causal || key <= row + q_offset));
        sp[t][e] = ok ? exp2_(fmaf(sp[t][e], scale_log2, -lse2[e >> 1])) : 0.0f;
      }
    float ds[8][4];  // dP, then dS
    product_nt<DH>(ds, os, qw, vs, lane);
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[t][e] = sp[t][e] * (ds[t][e] - dl[e >> 1]);
    product_acc<DH>(dqa, ds, ks, lane);  // dQ += dS K
    __syncthreads();
  }
  cp_wait<0>();

  bf16* dqb = dq + (size_t)bh * Tq * DH;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int col = 8 * t + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row < Tq)
        *reinterpret_cast<uint32_t*>(dqb + (size_t)row * DH + col) =
            pack_bf16(dqa[t][2 * h] * scale, dqa[t][2 * h + 1] * scale);
    }
  }
}

template <int DH>
int mma_launch(const void* q, const void* k, const void* v, const void* o, const float* lse, const void* dout,
               void* dq, void* dk, void* dv, float* delta, long long BHq, long long BHkv, long long Tq, long long Tk,
               int causal, long long q_offset, float scale, cudaStream_t stream) {
  constexpr int RS = DH + kPad;
  constexpr int smem_kv = (2 * kKV * RS + 4 * kQI * RS) * 2 + 4 * kQI * 4;
  constexpr int smem_q = (2 * kQB * RS + 4 * kKI * RS) * 2;
  if (Tq + q_offset + kQB > 0x7fffffffLL || Tk + kKV > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const long long n_kt = (Tk + kKV - 1) / kKV, n_qt = (Tq + kQB - 1) / kQB;
  if (BHkv * n_kt > 0x7fffffffLL || BHq * n_qt > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  int err = delta_launch<bf16>(o, dout, delta, BHq * Tq, DH, stream);
  if (err != cudaSuccess) return err;
  const int group = (int)(BHq / BHkv);
  auto kv_kernel = dkdv_mma_kernel<DH>;
  cudaError_t e = cudaFuncSetAttribute(kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (e != cudaSuccess) return (int)e;
  kv_kernel<<<(unsigned)(BHkv * n_kt), kMThreads, smem_kv, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, lse, delta, (bf16*)dk, (bf16*)dv,
      (int)BHkv, (int)Tq, (int)Tk, group, causal, (int)q_offset, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess || BHq * n_qt == 0) return (int)e;
  auto q_kernel = dq_mma_kernel<DH>;
  e = cudaFuncSetAttribute(q_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  if (e != cudaSuccess) return (int)e;
  q_kernel<<<(unsigned)(BHq * n_qt), kMThreads, smem_q, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, lse, delta, (bf16*)dq, (int)BHq,
      (int)Tq, (int)Tk, group, causal, (int)q_offset, scale, (int)n_qt);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Route 0: float32 on the float32 pipe.
// ---------------------------------------------------------------------------

constexpr int kFB = 64;        // rows of every staged tile
constexpr int kFThreads = 256;
constexpr int kFP = kFB + 4;   // row stride of the P and dS tiles

// Rows [r0, r0 + kFB) of a [n_rows, Dh] matrix into a [kFB][DH + 4] tile,
// zero past n_rows and past Dh.
template <int DH>
__device__ __forceinline__ void load_f32(float* dst, const float* __restrict__ src, int64_t r0, int64_t n_rows,
                                         int Dh) {
  constexpr int S = DH + 4;
  for (int e = threadIdx.x; e < kFB * DH; e += kFThreads) {
    const int r = e / DH, d = e % DH;
    dst[r * S + d] = r0 + r < n_rows && d < Dh ? src[(r0 + r) * Dh + d] : 0.0f;
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float x) {
  x = fmaf(a.x, b.x, x);
  x = fmaf(a.y, b.y, x);
  x = fmaf(a.z, b.z, x);
  return fmaf(a.w, b.w, x);
}

// s[r][c] = A[4r' rows] . B[16c' rows] and t[r][c] = C . E over DH columns:
// thread (tx, ty) takes rows ty*4 + r of A and C, rows tx + 16c of B and E.
template <int DH>
__device__ __forceinline__ void two_products(float (&s)[4][4], float (&t)[4][4], const float* A, const float* B,
                                             const float* C, const float* E, int tx, int ty) {
  constexpr int S = DH + 4;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[r][c] = t[r][c] = 0.0f;
#pragma unroll 2
  for (int d = 0; d < DH; d += 4) {
    float4 a[4], b[4], cc[4], e[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      a[r] = *reinterpret_cast<const float4*>(A + (ty * 4 + r) * S + d);
      cc[r] = *reinterpret_cast<const float4*>(C + (ty * 4 + r) * S + d);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      b[c] = *reinterpret_cast<const float4*>(B + (tx + 16 * c) * S + d);
      e[c] = *reinterpret_cast<const float4*>(E + (tx + 16 * c) * S + d);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = dot4(a[r], b[c], s[r][c]);
        t[r][c] = dot4(cc[r], e[c], t[r][c]);
      }
  }
}

// acc[r][c] += sum_j X[ty*4 + r][j] Y[j][col c], over the kFB rows j of Y; the
// thread's columns are the forward's: g*16W + tx*W + i.
template <int DH>
__device__ __forceinline__ void reduce_rows(float (&acc)[4][DH / 16], const float* X, const float* Y, int tx,
                                            int ty) {
  constexpr int S = DH + 4;
  constexpr int CPT = DH / 16;
  constexpr int W = CPT >= 4 ? 4 : CPT;
  constexpr int NG = CPT / W;
#pragma unroll 2
  for (int j = 0; j < kFB; j += 4) {
    float4 xr[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) xr[r] = *reinterpret_cast<const float4*>(X + (ty * 4 + r) * kFP + j);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      float yy[CPT];
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float* src = Y + (j + jj) * S + g * 16 * W + tx * W;
        if constexpr (W == 4) {
          const float4 t = *reinterpret_cast<const float4*>(src);
          yy[g * 4 + 0] = t.x; yy[g * 4 + 1] = t.y; yy[g * 4 + 2] = t.z; yy[g * 4 + 3] = t.w;
        } else {
          const float2 t = *reinterpret_cast<const float2*>(src);
          yy[g * 2 + 0] = t.x; yy[g * 2 + 1] = t.y;
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float x = jj == 0 ? xr[r].x : jj == 1 ? xr[r].y : jj == 2 ? xr[r].z : xr[r].w;
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[r][c] = fmaf(x, yy[c], acc[r][c]);
      }
    }
  }
}

template <int DH>
__device__ __forceinline__ void store_rows(float* dst, const float (&acc)[4][DH / 16], int64_t r0, int64_t n_rows,
                                           int Dh, float mul, int tx, int ty) {
  constexpr int CPT = DH / 16;
  constexpr int W = CPT >= 4 ? 4 : CPT;
  constexpr int NG = CPT / W;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int64_t row = r0 + ty * 4 + r;
    if (row >= n_rows) continue;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int i = 0; i < W; ++i) {
        const int col = g * 16 * W + tx * W + i;
        if (col < Dh) dst[row * Dh + col] = acc[r][g * W + i] * mul;
      }
  }
}

// b. dK/dV: block (kv head, 64-key tile); thread (tx, ty) scores keys
// ty*4 + r against queries tx + 16c and accumulates dK, dV rows ty*4 + r.
template <int DH>
__global__ void __launch_bounds__(kFThreads, 1)
dkdv_ffma_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                 const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dk, float* __restrict__ dv, int64_t BHkv, int64_t Tq, int64_t Tk, int Dh,
                 int group, int causal, int64_t q_offset, float scale) {
  constexpr int S = DH + 4;
  constexpr int CPT = DH / 16;
  extern __shared__ float4 ffma_smem[];
  float* Ks = reinterpret_cast<float*>(ffma_smem);  // [kFB][S]
  float* Vs = Ks + kFB * S;
  float* Qs = Vs + kFB * S;
  float* Os = Qs + kFB * S;       // dO
  float* Ps = Os + kFB * S;       // [kFB keys][kFP]: P^T
  float* Gs = Ps + kFB * kFP;     // [kFB keys][kFP]: dS^T
  float* Ls = Gs + kFB * kFP;     // [kFB]: lse
  float* Ds = Ls + kFB;           // [kFB]: Delta

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int64_t kvh = blockIdx.x % BHkv;
  const int64_t k0 = (int64_t)(blockIdx.x / BHkv) * kFB;
  const int64_t first_qt = causal && k0 > q_offset ? (k0 - q_offset) / kFB : 0;
  const int64_t n_qt = (Tq + kFB - 1) / kFB;
  load_f32<DH>(Ks, k + kvh * Tk * Dh, k0, Tk, Dh);
  load_f32<DH>(Vs, v + kvh * Tk * Dh, k0, Tk, Dh);

  float dka[4][CPT], dva[4][CPT];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) dka[r][c] = dva[r][c] = 0.0f;

  for (int g = 0; g < group; ++g) {
    const int64_t bh = kvh * group + g;
    for (int64_t qt = first_qt; qt < n_qt; ++qt) {
      const int64_t q0 = qt * kFB;
      __syncthreads();  // the last tile's products are done with Qs, Os, Ps, Gs
      load_f32<DH>(Qs, q + bh * Tq * Dh, q0, Tq, Dh);
      load_f32<DH>(Os, dout + bh * Tq * Dh, q0, Tq, Dh);
      if (threadIdx.x < kFB) {
        const bool ok = q0 + threadIdx.x < Tq;
        Ls[threadIdx.x] = ok ? lse[bh * Tq + q0 + threadIdx.x] : 0.0f;
        Ds[threadIdx.x] = ok ? delta[bh * Tq + q0 + threadIdx.x] : 0.0f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      two_products<DH>(s, dp, Ks, Qs, Vs, Os, tx, ty);  // S^T = K Q^T, dP^T = V dO^T
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int64_t key = k0 + ty * 4 + r;
          const int qi = tx + 16 * c;
          const bool ok = key < Tk && q0 + qi < Tq && (!causal || key <= q0 + qi + q_offset);
          const float p = ok ? expf(s[r][c] * scale - Ls[qi]) : 0.0f;
          Ps[(ty * 4 + r) * kFP + qi] = p;
          Gs[(ty * 4 + r) * kFP + qi] = p * (dp[r][c] - Ds[qi]);
        }
      __syncthreads();
      reduce_rows<DH>(dva, Ps, Os, tx, ty);  // dV += P^T dO
      reduce_rows<DH>(dka, Gs, Qs, tx, ty);  // dK += dS^T Q
    }
  }
  store_rows<DH>(dk + kvh * Tk * Dh, dka, k0, Tk, Dh, scale, tx, ty);
  store_rows<DH>(dv + kvh * Tk * Dh, dva, k0, Tk, Dh, 1.0f, tx, ty);
}

// c. dQ: block (q head, 64-query tile), most key tiles first; thread (tx,
// ty) scores queries ty*4 + r against keys tx + 16c.
template <int DH>
__global__ void __launch_bounds__(kFThreads, 1)
dq_ffma_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
               const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dq, int64_t BHq, int64_t Tq, int64_t Tk, int Dh, int group, int causal,
               int64_t q_offset, float scale, int n_q_tiles) {
  constexpr int S = DH + 4;
  constexpr int CPT = DH / 16;
  extern __shared__ float4 ffma_smem[];
  float* Qs = reinterpret_cast<float*>(ffma_smem);  // [kFB][S]
  float* Os = Qs + kFB * S;       // dO
  float* Ks = Os + kFB * S;
  float* Vs = Ks + kFB * S;
  float* Gs = Vs + kFB * S;       // [kFB queries][kFP]: dS

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int64_t bh = blockIdx.x % BHq;
  const int64_t q0 = (int64_t)(n_q_tiles - 1 - (int)(blockIdx.x / BHq)) * kFB;
  const int64_t kvh = bh / group;
  int64_t n_kv = (Tk + kFB - 1) / kFB;
  if (causal) {
    const int64_t last = (q0 + q_offset + kFB - 1) / kFB;
    n_kv = n_kv < last + 1 ? n_kv : last + 1;
  }
  load_f32<DH>(Qs, q + bh * Tq * Dh, q0, Tq, Dh);
  load_f32<DH>(Os, dout + bh * Tq * Dh, q0, Tq, Dh);
  float lr[4], dl[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int64_t row = q0 + ty * 4 + r;
    lr[r] = row < Tq ? lse[bh * Tq + row] : 0.0f;
    dl[r] = row < Tq ? delta[bh * Tq + row] : 0.0f;
  }
  float dqa[4][CPT];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) dqa[r][c] = 0.0f;

  for (int64_t kt = 0; kt < n_kv; ++kt) {
    const int64_t k0 = kt * kFB;
    __syncthreads();  // the last tile's dQ product is done with Ks and Gs
    load_f32<DH>(Ks, k + kvh * Tk * Dh, k0, Tk, Dh);
    load_f32<DH>(Vs, v + kvh * Tk * Dh, k0, Tk, Dh);
    __syncthreads();
    float s[4][4], dp[4][4];
    two_products<DH>(s, dp, Qs, Ks, Os, Vs, tx, ty);  // S = Q K^T, dP = dO V^T
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int64_t row = q0 + ty * 4 + r;
        const int64_t key = k0 + tx + 16 * c;
        const bool ok = key < Tk && row < Tq && (!causal || key <= row + q_offset);
        const float p = ok ? expf(s[r][c] * scale - lr[r]) : 0.0f;
        Gs[(ty * 4 + r) * kFP + tx + 16 * c] = p * (dp[r][c] - dl[r]);
      }
    __syncthreads();
    reduce_rows<DH>(dqa, Gs, Ks, tx, ty);  // dQ += dS K
  }
  store_rows<DH>(dq + bh * Tq * Dh, dqa, q0, Tq, Dh, scale, tx, ty);
}

template <int DH>
int ffma_launch(const void* q, const void* k, const void* v, const void* o, const float* lse, const void* dout,
                void* dq, void* dk, void* dv, float* delta, long long BHq, long long BHkv, long long Tq, long long Tk,
                int Dh, int causal, long long q_offset, float scale, cudaStream_t stream) {
  constexpr int S = DH + 4;
  constexpr int smem_kv = (4 * kFB * S + 2 * kFB * kFP + 2 * kFB) * (int)sizeof(float);
  constexpr int smem_q = (4 * kFB * S + kFB * kFP) * (int)sizeof(float);
  const long long n_kt = (Tk + kFB - 1) / kFB, n_qt = (Tq + kFB - 1) / kFB;
  if (BHkv * n_kt > 0x7fffffffLL || BHq * n_qt > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  int err = delta_launch<float>(o, dout, delta, BHq * Tq, Dh, stream);
  if (err != cudaSuccess) return err;
  const int group = (int)(BHq / BHkv);
  auto kv_kernel = dkdv_ffma_kernel<DH>;
  cudaError_t e = cudaFuncSetAttribute(kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (e != cudaSuccess) return (int)e;
  kv_kernel<<<(unsigned)(BHkv * n_kt), kFThreads, smem_kv, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, lse, delta, (float*)dk, (float*)dv,
      BHkv, Tq, Tk, Dh, group, causal, q_offset, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess || BHq * n_qt == 0) return (int)e;
  auto q_kernel = dq_ffma_kernel<DH>;
  e = cudaFuncSetAttribute(q_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  if (e != cudaSuccess) return (int)e;
  q_kernel<<<(unsigned)(BHq * n_qt), kFThreads, smem_q, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, lse, delta, (float*)dq, BHq, Tq, Tk,
      Dh, group, causal, q_offset, scale, (int)n_qt);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype 0 = float32 on route 0 (ffma, Dh 1..128); dtype 1 = bfloat16 on
// route 1 (mma, Dh 64 or 128, 16-byte aligned arrays). q, o, dout, dq
// [BHq, Tq, Dh]; k, v, dk, dv [BHkv, Tk, Dh]; lse [BHq, Tq] float32 from
// the forward; delta [BHq, Tq] float32 scratch. `scale` multiplies q.k.
// Three launches on `stream`; returns the first CUDA error.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v, const void* o, const void* lse,
                               const void* dout, void* dq, void* dk, void* dv, void* delta, long long BHq,
                               long long BHkv, long long Tq, long long Tk, long long Dh, int causal,
                               long long q_offset, float scale, int dtype, int route, void* stream) {
  if (BHkv <= 0 || BHq % BHkv != 0 || Tk <= 0 || Tq < 0 || q_offset < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* L = (const float*)lse;
  float* D = (float*)delta;
  if (route == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    for (const void* p : {q, k, v, o, dout, (const void*)dq, (const void*)dk, (const void*)dv})
      if ((uintptr_t)p % 16) return (int)cudaErrorMisalignedAddress;
    if (Dh == 64) return mma_launch<64>(q, k, v, o, L, dout, dq, dk, dv, D, BHq, BHkv, Tq, Tk, causal, q_offset, scale, s);
    if (Dh == 128) return mma_launch<128>(q, k, v, o, L, dout, dq, dk, dv, D, BHq, BHkv, Tq, Tk, causal, q_offset, scale, s);
    return (int)cudaErrorInvalidValue;
  }
  if (route != 0 || dtype != 0) return (int)cudaErrorInvalidValue;
  const int dh = (int)Dh;
  if (Dh >= 1 && Dh <= 32) return ffma_launch<32>(q, k, v, o, L, dout, dq, dk, dv, D, BHq, BHkv, Tq, Tk, dh, causal, q_offset, scale, s);
  if (Dh > 32 && Dh <= 64) return ffma_launch<64>(q, k, v, o, L, dout, dq, dk, dv, D, BHq, BHkv, Tq, Tk, dh, causal, q_offset, scale, s);
  if (Dh > 64 && Dh <= 128) return ffma_launch<128>(q, k, v, o, L, dout, dq, dk, dv, D, BHq, BHkv, Tq, Tk, dh, causal, q_offset, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
