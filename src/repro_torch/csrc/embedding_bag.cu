// embedding_bag: weighted bag reduction over embedding rows, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `embedding_bag` in
// src/repro/kernels/embedding_bag/kernel.py (body `_embedding_bag_kernel`):
//
//   out[b, d] = sum_l w[b, l] * table[idx[b, l], d]
//
// with table [V, D] float32, idx [B, L] int32 and w [B, L] float32 (weight 0
// on padded slots, whose index is 0). DIN's user tower pools its history
// with it (mean weights, normalised by the caller).
//
// What bounds it: bytes. Each (bag, slot) reads one table row and does D
// multiply-adds on it; at DIN's D = 18 that is one operation per four bytes
// gathered, far below the card's ~20 operations per byte. The least traffic
// is the table, idx and w read once and out written once; the gathered rows
// (B * L * D * 4 bytes) are what the kernel actually moves, from L2 where a
// row repeats.
//
// Design. The TPU kernel pads D to a 128-lane tile and walks a sequential
// grid (b, l, d tile), one row tile per step, with the output row resident
// in VMEM. A 72-byte row (D = 18) is neither a multiple of 32 lanes nor of
// 16-byte vectors, so padding or copying the table would multiply its
// traffic. Instead one thread owns one (bag, column) output: the flat index
// b * D + d runs over consecutive threads, so a warp reads the D
// consecutive floats of each of its bags' rows together (one or two bags
// per warp at D = 18) and idx[b, l], w[b, l] are one broadcast load for the
// threads of a bag. The slot loop runs inside the thread (it takes the place
// of the TPU's sequential l axis) with the sum in a register; no atomics,
// no shared memory, no padding. The kernel trusts idx to lie in [0, V).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
embedding_bag_kernel(const float* __restrict__ table, const int32_t* __restrict__ idx,
                     const float* __restrict__ w, float* __restrict__ out,
                     int64_t B, int64_t L, int64_t D) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= B * D) return;
  const int64_t b = i / D;
  const int64_t d = i - b * D;
  const int32_t* irow = idx + b * L;
  const float* wrow = w + b * L;
  float acc = 0.0f;
#pragma unroll 4
  for (int64_t l = 0; l < L; ++l) {
    const float wv = __ldg(wrow + l);
    const float tv = __ldg(table + (int64_t)__ldg(irow + l) * D + d);
    acc = fmaf(wv, tv, acc);
  }
  out[i] = acc;
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch.
int embedding_bag_launch(const void* table, const void* idx, const void* w, void* out,
                         long long B, long long L, long long D, void* stream) {
  if (B == 0 || D == 0) return (int)cudaGetLastError();
  const long long n = B * D;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  embedding_bag_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)table, (const int32_t*)idx, (const float*)w, (float*)out, B, L, D);
  return (int)cudaGetLastError();
}

const char* embedding_bag_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
