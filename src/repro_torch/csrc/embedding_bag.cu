// embedding_bag: weighted bag reduction over embedding rows, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `embedding_bag` in
// src/repro/kernels/embedding_bag/kernel.py (body `_embedding_bag_kernel`):
//
//   out[b, d] = sum_l w[b, l] * table[idx[b, l], d]
//
// with table [V, D] float32, idx [B, L] int32 and w [B, L] float32 (weight 0
// on padded slots, whose index is 0). DIN's user tower pools its history
// with it (mean weights, normalised by the caller). Every slot is gathered
// and multiplied, weight 0 or not, as the reference does: an inf or NaN row
// under a padded slot gives NaN.
//
// What bounds it: bytes. Each (bag, slot) reads one table row and does D
// multiply-adds on it; at DIN's D = 18 that is one operation per four bytes
// gathered, far below the card's ~20 operations per byte. The least traffic
// is the table, idx and w read once and out written once; the gathered rows
// (B * L * D * 4 bytes, 1.887 GB at DIN's shape) are what the kernel
// actually moves, from L2 where a row repeats.
//
// Design. A warp owns one bag. It stages up to 128 of the bag's slots (idx
// and w, one coalesced, evict-first load each: read once, so they should
// not take L2 room from the table) in its part of shared memory. A row is
// P parts of 8 bytes (float2, when D is even and the pointers are 8-byte
// aligned) or of 4 bytes (otherwise); the warp splits into G = 32 / P
// groups of P lanes (3 groups of 9 at D = 18, 27 lanes busy), group g
// takes slots g, g + G, g + 2G, ... and every lane issues the loads of 8
// slots before it adds any, so a warp has 3 x 8 whole rows in flight. Rows
// wider than 32 parts take more passes. Each lane sums its slots in slot
// order and the groups are added in group order at the end, so two
// launches give the same bits. No atomics, no padding of the table.
//
// What was tried, at DIN's shape (1,000,000 x 18 table, 262,144 bags of
// 100; NVIDIA H100 80GB HBM3, timed with kernel_ab.py): the first design
// (one thread per (bag, column), a serial slot loop) took 1.01 ms a call
// back to back, this one 0.86. Slots passed by shuffle from registers
// gained nothing; more loads a lane (fewer warps an SM) lost; bypassing L1
// for the table, or pinning part of it in L2 with a persisting access
// window, gained nothing; reading the table in row-range passes that each
// fit the L2 lost more the more passes it took, since every pass walks all
// the slots again. Whatever the design, a random 72-byte row touches 3.25
// sectors of 32 bytes on average, and with the table larger than the L2
// most of them come from device memory: the same gathers from DIN's
// category table, which the L2 holds, take under half the time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;             // bags (one a warp) a block
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 128;           // slots a warp stages in shared memory at a time
constexpr int kBatch = 8;             // row loads a lane issues before it adds them

template <int kVec>
__device__ __forceinline__ void load_row_part(const float* p, float (&v)[kVec]) {
  if constexpr (kVec == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = __ldg(p);
  }
}

template <int kVec>
__device__ __forceinline__ void store_part(float* p, const float (&v)[kVec]) {
  if constexpr (kVec == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

template <int kVec>
__global__ void __launch_bounds__(kThreads)
embedding_bag_kernel(const float* __restrict__ table, const int32_t* __restrict__ idx,
                     const float* __restrict__ w, float* __restrict__ out,
                     int64_t B, int64_t L, int64_t D) {
  __shared__ int32_t s_idx[kWarps][kChunk];
  __shared__ float s_w[kWarps][kChunk];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t b = (int64_t)blockIdx.x * kWarps + warp;
  if (b >= B) return;  // the whole warp leaves together
  const int32_t* irow = idx + b * L;
  const float* wrow = w + b * L;
  const int32_t* my_idx = s_idx[warp];
  const float* my_w = s_w[warp];
  const int64_t parts = D / kVec;
  for (int64_t p0 = 0; p0 < parts; p0 += 32) {
    const int np = (int)(parts - p0 < 32 ? parts - p0 : 32);  // parts this pass
    const int groups = 32 / np;
    const int g = lane / np;
    const int p = lane - g * np;
    const bool busy = g < groups;
    const int64_t col = (p0 + p) * kVec;
    float acc[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) acc[k] = 0.0f;
    for (int64_t l0 = 0; l0 < L; l0 += kChunk) {
      const int n = (int)(L - l0 < kChunk ? L - l0 : kChunk);
      __syncwarp();
#pragma unroll
      for (int k = 0; k < kChunk / 32; ++k) {
        const int slot = k * 32 + lane;
        if (slot < n) {
          s_idx[warp][slot] = __ldcs(irow + l0 + slot);
          s_w[warp][slot] = __ldcs(wrow + l0 + slot);
        }
      }
      __syncwarp();
      const int steps = (n + groups - 1) / groups;  // slots a group takes from this chunk
      for (int s0 = 0; s0 < steps; s0 += kBatch) {
        float tv[kBatch][kVec];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int slot = g + groups * (s0 + u);
          if (busy && s0 + u < steps && slot < n) {
            load_row_part<kVec>(table + (int64_t)my_idx[slot] * D + col, tv[u]);
          } else {
#pragma unroll
            for (int k = 0; k < kVec; ++k) tv[u][k] = 0.0f;
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int slot = g + groups * (s0 + u);
          if (busy && s0 + u < steps && slot < n) {
            const float wv = my_w[slot];
#pragma unroll
            for (int k = 0; k < kVec; ++k) acc[k] = fmaf(wv, tv[u][k], acc[k]);
          }
        }
      }
    }
    // Add the groups' partial sums in group order into group 0's lanes.
    float sum[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) sum[k] = acc[k];
    for (int h = 1; h < groups; ++h) {
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        sum[k] += __shfl_sync(0xffffffffu, acc[k], (lane + h * np) & 31);
      }
    }
    if (g == 0) store_part<kVec>(out + b * D + col, sum);
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch.
int embedding_bag_launch(const void* table, const void* idx, const void* w, void* out,
                         long long B, long long L, long long D, void* stream) {
  if (B == 0 || D == 0) return (int)cudaGetLastError();
  const unsigned blocks = (unsigned)((B + kWarps - 1) / kWarps);
  const bool vec = D % 2 == 0 && (uintptr_t)table % 8 == 0 && (uintptr_t)out % 8 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  const auto* tp = (const float*)table;
  const auto* ip = (const int32_t*)idx;
  const auto* wp = (const float*)w;
  auto* op = (float*)out;
  if (vec) {
    embedding_bag_kernel<2><<<blocks, kThreads, 0, s>>>(tp, ip, wp, op, B, L, D);
  } else {
    embedding_bag_kernel<1><<<blocks, kThreads, 0, s>>>(tp, ip, wp, op, B, L, D);
  }
  return (int)cudaGetLastError();
}

const char* embedding_bag_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
