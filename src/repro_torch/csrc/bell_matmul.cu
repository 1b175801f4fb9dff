// bell_matmul: block-ELL sparse matrix times dense matrix, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `bell_matmul` in
// src/repro/kernels/bsr_spmm/kernel.py (body `_bell_spmm_kernel`):
//
//   Y[i*bs + a, f] = sum_j mask[i, j] * sum_b blocks[i, j, a, b] * X[cols[i, j]*bs + b, f]
//
// with blocks [n_block_rows, max_nnz, bs, bs] and X [n_block_rows*bs, F],
// both float32 or both bfloat16, and cols/mask [n_block_rows, max_nnz]
// int32. DiDiC's kernel route calls it with F = k (2 or 4) and bs = 128.
//
// What bounds it: bytes. Every stored block is read once and used for F
// columns, so a block of bs*bs values does 2*bs*bs*F float operations on
// 4*bs*bs bytes: F/2 operations per byte, far below the ~20 the card's
// float32 units need per byte of device memory at DiDiC's F of 2 or 4.
// The least traffic is the stored (unmasked) blocks once, X's touched
// tiles once and Y once.
//
// Design. One warp owns one output row a of one block row i and a tile of
// up to 8 output columns. The TPU kernel walked (i, j, f tile)
// sequentially and kept the output tile resident in VMEM across the slot
// axis j; here the warp walks the slots j itself and keeps its partial sums
// in registers, so nothing crosses warps until the end. A slot whose mask
// is 0 is skipped: its block is zero by construction. For a stored slot the
// lanes split the bs columns of the block's row a, so the row is one
// coalesced read (512 bytes at bs = 128, float32), and each lane multiplies
// its A value by the matching X row (X is small and stays in L1/L2). After
// the last slot a shuffle tree adds the 32 lanes' partial sums. No shared
// memory and no barriers: a block of 8 warps covers 8 rows, and the grid
// (block rows x bs/8 x ceil(F/8)) gives the card about a thousand blocks
// at DiDiC's shape. Wider F is tiled by 8 and re-reads the blocks per tile,
// which only the tests' small matrices do.
//
// Precision: FFMA in float32, no tensor cores and no TF32, so float32 meets
// 1e-5 against the plain version; bfloat16 inputs are widened with
// __bfloat162float, accumulated in float32 and rounded once on store.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;   // output rows per block
constexpr int kFT = 8;      // output columns per warp (registers a lane)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
bell_matmul_kernel(const T* __restrict__ blocks, const int32_t* __restrict__ cols,
                   const int32_t* __restrict__ mask, const T* __restrict__ x,
                   T* __restrict__ out, int max_nnz, int bs, int64_t F) {
  const int lane = threadIdx.x & 31;
  const int a = blockIdx.y * kWarps + (threadIdx.x >> 5);
  if (a >= bs) return;  // whole warps only; no barriers below
  const int64_t i = blockIdx.x;
  const int64_t f0 = (int64_t)blockIdx.z * kFT;
  const int fn = (int)(F - f0 < kFT ? F - f0 : kFT);
  float acc[kFT];
#pragma unroll
  for (int c = 0; c < kFT; ++c) acc[c] = 0.0f;

  for (int j = 0; j < max_nnz; ++j) {
    const int64_t slot = i * max_nnz + j;
    if (__ldg(mask + slot) == 0) continue;
    const int64_t col = __ldg(cols + slot);
    const T* arow = blocks + (slot * bs + a) * bs;
    const T* xtile = x + col * bs * F + f0;
    for (int b = lane; b < bs; b += 32) {
      const float av = to_f(arow[b]);
      const T* xr = xtile + (int64_t)b * F;
#pragma unroll
      for (int c = 0; c < kFT; ++c) {
        if (c < fn) acc[c] = fmaf(av, to_f(xr[c]), acc[c]);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < kFT; ++c) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], off);
  }
  if (lane == 0) {
    T* orow = out + (i * bs + a) * F + f0;
#pragma unroll
    for (int c = 0; c < kFT; ++c) {
      if (c < fn) store(orow + c, acc[c]);
    }
  }
}

template <typename T>
int launch(const void* blocks, const void* cols, const void* mask, const void* x, void* out,
           long long n_block_rows, long long max_nnz, long long bs, long long F, void* stream) {
  const dim3 grid((unsigned)n_block_rows, (unsigned)((bs + kWarps - 1) / kWarps),
                  (unsigned)((F + kFT - 1) / kFT));
  bell_matmul_kernel<T><<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const T*)blocks, (const int32_t*)cols, (const int32_t*)mask, (const T*)x, (T*)out,
      (int)max_nnz, (int)bs, (int64_t)F);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError().
int bell_matmul_launch(const void* blocks, const void* cols, const void* mask, const void* x,
                       void* out, long long n_block_rows, long long max_nnz, long long bs,
                       long long F, int dtype, void* stream) {
  if (n_block_rows == 0 || F == 0) return (int)cudaGetLastError();
  if (dtype == 1) {
    return launch<__nv_bfloat16>(blocks, cols, mask, x, out, n_block_rows, max_nnz, bs, F, stream);
  }
  return launch<float>(blocks, cols, mask, x, out, n_block_rows, max_nnz, bs, F, stream);
}

const char* bell_matmul_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
