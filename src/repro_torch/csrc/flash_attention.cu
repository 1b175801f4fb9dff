// flash_attention: causal or non-causal GQA attention with an online
// softmax, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention` in
// src/repro/kernels/flash_attention/kernel.py (body `_flash_kernel`):
//
//   o[bh, i] = sum_j softmax_j(s[i, j]) * v[bh / G, j],
//   s[i, j]  = (q[bh, i] . k[bh / G, j]) * Dh^-1/2, masked to -1e30 where
//              key j lies past Tk or (causal) past query position
//              i + q_offset,
//
// with q [B*Hq, Tq, Dh], k/v [B*Hkv, Tk, Dh] batch-head major (G = Hq/Hkv;
// q head b*Hq + h reads kv head b*Hkv + h/G, no repeated copy), float32 or
// bfloat16, accumulated in float32, the output in the input type and
// divided by max(l, 1e-30) as the TPU kernel does.
//
// What bounds it: operations. A causal call does about 2*B*Hq*Tq*Tk*Dh
// float operations on ~4*B*Hkv*Tk*Dh bytes; at granite-3-8b's prefill shape
// (Hq 32, Hkv 8, T 4096, Dh 128) that is ~2,000 operations a byte, above
// the tensor cores' ~295 and far above the float32 pipe's ~20. This first
// kernel uses the float32 pipe (FFMA) for both types, so its floor is
// the 67 TFLOP/s float32 rate, not the tensor cores' 989 TFLOP/s.
//
// Design. The TPU kernel walks a grid (bh, q block, kv block) with the kv
// axis sequential, keeping m, l and the output tile in VMEM scratch. Here
// one 256-thread block owns one (bh, 64-query tile) and loops over 64-key
// tiles itself, carrying m, l and the 64 x Dh accumulator in registers
// (FlashAttention-2's schedule). Per key tile: K is staged in shared memory
// (float32, rows padded to Dh+4 floats so the column reads of 16 threads
// fall in distinct banks), each thread forms a 4 x 4 block of scores
// (rows 4*ty.., keys tx + 16c), the row max and sum are reduced over the 16
// threads of a row with shuffles, the probabilities go to shared memory,
// V replaces K in the same buffer, and each thread adds its 4 rows x Dh/16
// columns of P V. Key tiles wholly above the diagonal are never loaded
// (the TPU kernel's block skip); blocks with the most key tiles start
// first. Ragged Tq and Tk are masked, never padded in memory: missing rows
// load as zeros and are not stored. Masked scores are -1e30 and key tile 0
// always holds an unmasked key (q_offset >= 0), so a masked score
// contributes exactly 0 whatever the tiling. expf, not __expf.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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
int launch(const void* q, const void* k, const void* v, void* o, long long BHq, long long BHkv,
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
int launch_dh(const void* q, const void* k, const void* v, void* o, long long BHq, long long BHkv,
              long long Tq, long long Tk, long long Dh, int causal, long long q_offset,
              float scale, cudaStream_t s) {
  const int dh = (int)Dh;
  if (Dh <= 32) return launch<T, 32>(q, k, v, o, BHq, BHkv, Tq, Tk, dh, causal, q_offset, scale, s);
  if (Dh <= 64) return launch<T, 64>(q, k, v, o, BHq, BHkv, Tq, Tk, dh, causal, q_offset, scale, s);
  if (Dh <= 128) return launch<T, 128>(q, k, v, o, BHq, BHkv, Tq, Tk, dh, causal, q_offset, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns the CUDA error of the launch.
int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                           long long BHq, long long BHkv, long long Tq, long long Tk,
                           long long Dh, int causal, long long q_offset, float scale,
                           int dtype, void* stream) {
  if (BHq == 0 || Tq == 0) return (int)cudaGetLastError();
  if (BHkv <= 0 || BHq % BHkv != 0 || Tk <= 0 || q_offset < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch_dh<float>(q, k, v, o, BHq, BHkv, Tq, Tk, Dh, causal, q_offset, scale, s);
  if (dtype == 1)
    return launch_dh<__nv_bfloat16>(q, k, v, o, BHq, BHkv, Tq, Tk, Dh, causal, q_offset, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
