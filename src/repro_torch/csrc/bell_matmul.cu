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
// tiles once and Y once. At DiDiC's GIS 0.01 matrix that is ~200 MB of
// blocks, so the kernel's whole job is to keep enough of them in flight.
//
// Design: a pipelined stream of the stored blocks. One 128-thread block owns
// one slab of 16 output rows (a .. a+15) of one block row i, for a tile of
// up to 4 output columns, so no two blocks write the same output and no
// reduction crosses blocks (62 x 8 = 496 blocks at DiDiC's shape). It first
// reads the row's mask and cols (max_nnz ints each) and compacts the stored
// slots into shared memory in slot order; no per-slot dependent global load
// stays in the loop. Then one thread streams, for each stored slot j, the
// slab's rows of block (i, j) — one contiguous run of 16*bs values, 8 KB at
// bs = 128 in float32 — with a 1-D TMA copy (`cp.async.bulk`) into a ring of
// up to 4 shared-memory stages, each with an `mbarrier` that counts the
// bytes; where X's tile of the slot (rows cols[j]*bs .. +bs, all F columns,
// 2 KB at F = 4) is a 16-byte multiple it comes in the same stage, else the
// threads read it from X (small, L2-resident). Each thread owns one column
// b of the slab (b, b + 128, ... for wider blocks) and multiplies its 16
// values by X's row b into 16 x 4 float32 partial sums in registers; the
// slot is released to the next copy after a block barrier. At the end a
// shuffle tree and a fixed-order sum of the 4 warps give each output its
// value, written once and never atomically: the same inputs give the same
// bits on every run. A slot whose mask is 0 is skipped: its block is zero
// by construction.
//
// Precision: FFMA in float32, no tensor cores and no TF32, so float32 meets
// 1e-5 against the plain version; bfloat16 inputs are widened with
// __bfloat162float, accumulated in float32 and rounded once on store.
// Requires bs * sizeof(T) to be a multiple of 16 bytes (the copy unit).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;       // output rows a block owns
constexpr int kFT = 4;          // output columns a block owns
constexpr int kMaxStages = 4;
constexpr int kMaxSmem = 232448;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
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

// 1-D TMA: `bytes` (a multiple of 16) from global to shared memory, both
// 16-byte aligned, counted on `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Shared memory: [stages][stage_bytes] ring (the A slab, then X's tile) |
// one mbarrier a stage | the compacted slots and their block columns.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bell_matmul_kernel(const T* __restrict__ blocks, const int32_t* __restrict__ cols,
                   const int32_t* __restrict__ mask, const T* __restrict__ x,
                   T* __restrict__ out, int max_nnz, int bs, int64_t F, int n_slabs, int stages,
                   int stage_bytes, int x_in_stage) {
  extern __shared__ uint8_t bell_smem[];
  __shared__ int warp_count[kWarps];
  __shared__ float red[kWarps][kRows * kFT];
  const uint32_t pad = (128u - (smem_u32(bell_smem) & 127u)) & 127u;
  uint8_t* smem = bell_smem + pad;  // 128-byte aligned
  const uint32_t ring = smem_u32(smem);
  const uint32_t bars = ring + stages * stage_bytes;
  int* s_slot = reinterpret_cast<int*>(smem + stages * stage_bytes + 8 * kMaxStages);
  int* s_col = s_slot + max_nnz;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t i = blockIdx.x / n_slabs;
  const int a0 = (int)(blockIdx.x % n_slabs) * kRows;
  const int rows = bs - a0 < kRows ? bs - a0 : kRows;
  const int64_t f0 = (int64_t)blockIdx.y * kFT;
  const int fn = (int)(F - f0 < kFT ? F - f0 : kFT);

  // Compact the stored slots of block row i, in slot order.
  int n_stored = 0;
  for (int base = 0; base < max_nnz; base += kThreads) {
    const int j = base + tid;
    const bool stored = j < max_nnz && __ldg(mask + i * max_nnz + j) != 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, stored);
    if (lane == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();
    int pos = n_stored + __popc(ballot & ((1u << lane) - 1u));
    for (int w = 0; w < warp; ++w) pos += warp_count[w];
    if (stored) {
      s_slot[pos] = j;
      s_col[pos] = __ldg(cols + i * max_nnz + j);
    }
    for (int w = 0; w < kWarps; ++w) n_stored += warp_count[w];
    __syncthreads();
  }

  if (tid == 0) {
    for (int s = 0; s < stages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bars + 8 * s) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  const uint32_t a_bytes = (uint32_t)(rows * bs * sizeof(T));
  const uint32_t x_off = (uint32_t)(kRows * bs * sizeof(T));
  const uint32_t x_bytes = x_in_stage ? (uint32_t)(bs * F * sizeof(T)) : 0u;
  auto issue = [&](int n, int st) {
    const int64_t slot = i * max_nnz + s_slot[n];
    const uint32_t bar = bars + 8 * st;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                 "r"(a_bytes + x_bytes)
                 : "memory");
    bulk_copy(ring + st * stage_bytes, blocks + (slot * bs + a0) * bs, a_bytes, bar);
    if (x_in_stage) bulk_copy(ring + st * stage_bytes + x_off, x + (int64_t)s_col[n] * bs * F, x_bytes, bar);
  };
  if (tid == 0) {
    for (int n = 0; n < stages && n < n_stored; ++n) issue(n, n);
  }

  float acc[kRows][kFT];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int f = 0; f < kFT; ++f) acc[r][f] = 0.0f;

  for (int n = 0; n < n_stored; ++n) {
    const int st = n % stages;
    mbar_wait(bars + 8 * st, (uint32_t)(n / stages) & 1u);
    const T* as = reinterpret_cast<const T*>(smem + st * stage_bytes);
    const T* xt = x_in_stage ? reinterpret_cast<const T*>(smem + st * stage_bytes + x_off)
                             : x + (int64_t)s_col[n] * bs * F + f0;
    for (int b = tid; b < bs; b += kThreads) {
      float xv[kFT];
#pragma unroll
      for (int f = 0; f < kFT; ++f) xv[f] = f < fn ? to_f(xt[(int64_t)b * F + f]) : 0.0f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float av = to_f(as[r * bs + b]);
#pragma unroll
        for (int f = 0; f < kFT; ++f) acc[r][f] = fmaf(av, xv[f], acc[r][f]);
      }
    }
    __syncthreads();  // every thread is done with stage st
    if (tid == 0 && n + stages < n_stored) issue(n + stages, st);
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int f = 0; f < kFT; ++f) {
      float v = acc[r][f];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) red[warp][r * kFT + f] = v;
    }
  __syncthreads();
  if (tid < kRows * kFT) {
    const int r = tid / kFT;
    const int f = tid % kFT;
    if (r < rows && f < fn) {
      float v = red[0][tid];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) v += red[w][tid];
      store(out + (i * bs + a0 + r) * F + f0 + f, v);
    }
  }
}

template <typename T>
int launch(const void* blocks, const void* cols, const void* mask, const void* x, void* out,
           long long n_block_rows, long long max_nnz, long long bs, long long F, void* stream) {
  if ((bs * (long long)sizeof(T)) % 16 != 0 || ((uintptr_t)blocks) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const long long x_tile = bs * F * (long long)sizeof(T);
  const int x_in_stage = F <= kFT && x_tile % 16 == 0 && ((uintptr_t)x) % 16 == 0;
  const long long a_area = kRows * bs * (long long)sizeof(T);
  const long long stage_bytes = (a_area + (x_in_stage ? x_tile : 0) + 127) / 128 * 128;
  int stages = kMaxStages;
  auto smem_for = [&](int st) { return 128 + st * stage_bytes + 8 * kMaxStages + 8 * max_nnz; };
  while (stages > 1 && smem_for(stages) > kMaxSmem) --stages;
  if (smem_for(stages) > kMaxSmem) return (int)cudaErrorInvalidValue;
  const long long n_slabs = (bs + kRows - 1) / kRows;
  const long long n_ftiles = (F + kFT - 1) / kFT;
  if (n_block_rows * n_slabs > 0x7fffffffLL || n_ftiles > 65535) return (int)cudaErrorInvalidConfiguration;
  const int smem = (int)smem_for(stages);
  auto kernel = bell_matmul_kernel<T>;
  // The shared-memory cap lasts for the process: raise it only when a
  // launch asks for more than any before it on this device.
  static std::atomic<int> smem_cap[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (smem > smem_cap[dev].load(std::memory_order_relaxed)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_cap[dev].store(smem, std::memory_order_relaxed);
  }
  const dim3 grid((unsigned)(n_block_rows * n_slabs), (unsigned)n_ftiles);
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)blocks, (const int32_t*)cols, (const int32_t*)mask, (const T*)x, (T*)out,
      (int)max_nnz, (int)bs, (int64_t)F, (int)n_slabs, stages, (int)stage_bytes, x_in_stage);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError(), or
// cudaErrorInvalidValue where a block row is not a multiple of 16 bytes.
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
