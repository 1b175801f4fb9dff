// segment_sum: a float32 segment sum in a fixed order, for Hopper (sm_90a).
//
// Replaces no Pallas kernel. The JAX package sums the graph side's messages
// with jax.ops.segment_sum, an XLA scatter-add that repeats bit for bit from
// run to run; PyTorch's index_add_ on the card sums float32 by atomics, in
// an order that changes from run to run. This kernel gives the port back
// the reference's repeatable sums (a retried DiDiC pass, a resumed
// training run and a re-dispatched step are bit-identical):
//
//   out[s, c] = sum over the edges e with seg[e] == s of data[e, c]
//
// with data [E, F] float32, and the edges grouped by segment as a stable
// permutation perm [E] (int64: the edge ids in ascending segment order,
// ascending edge id within a segment) plus CSR offsets [n + 1] (int64).
// A segment with no edge gets 0.
//
// The order. Each segment's rows are added one after another, in ascending
// edge id, starting from +0.0, with __fadd_rn (no contraction, round to
// nearest). That is the order of PyTorch's index_add_ on the CPU, which
// adds the source rows into a zero output in index order, so the card's
// result equals the plain version run on the CPU bit for bit, and two
// launches give the same bits.
//
// What bounds it: bytes. Every data value is read once and added once: one
// operation per 4 bytes, far below the card's ~20 operations per byte. The
// least traffic is data, the permutation and offsets read once and out
// written once.
//
// Design. Two kernels, one launch. The short kernel: a warp takes 32 / P
// segments, P lanes each (P the next power of two of F, at most 32); a lane
// owns one column of its segment, and for F > 32 walks the columns 32
// apart. Neighbouring lanes read neighbouring columns of one data row
// (coalesced for F >= 32); the row's edge id is one address for the whole
// group. A lane issues the loads of 16 edges before it adds them, still in
// edge order, to keep loads in flight. The long kernel takes the segments
// of more than `long_at` edges (the hubs of a power-law graph: Twitter's
// largest has 47,691): one block a segment, which gathers a chunk of its
// rows into shared memory with every thread (loads independent of each
// other, so they overlap), then adds the chunk in edge order with one
// thread a column. In the short kernel a hub's chain of dependent loads
// took 8.6 ms (two memory round trips for every 8 edges); in the long
// kernel the chain is the adds themselves. No atomics.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;             // warps a block of the short kernel
constexpr int kThreads = 32 * kWarps;
constexpr int kBatch = 16;            // loads a lane issues before it adds them
constexpr int kLongThreads = 512;     // threads a block of the long kernel
constexpr int kLongFloats = 12288;    // its chunk in shared memory: 48 KB

__global__ void __launch_bounds__(kThreads)
segment_sum_short_kernel(const float* __restrict__ data, const int64_t* __restrict__ perm,
                         const int64_t* __restrict__ offsets, float* __restrict__ out,
                         int64_t n, int64_t F, int P, int64_t long_at) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int groups = 32 / P;
  const int g = lane / P;
  const int p = lane - g * P;
  const int64_t s = ((int64_t)blockIdx.x * kWarps + warp) * groups + g;
  if (g >= groups || s >= n) return;  // no warp-wide primitive follows
  const int64_t begin = __ldg(offsets + s);
  const int64_t end = __ldg(offsets + s + 1);
  if (end - begin > long_at) return;  // the long kernel's
  for (int64_t c = p; c < F; c += P) {
    float acc = 0.0f;
    int64_t j = begin;
    for (; j + kBatch <= end; j += kBatch) {
      int64_t e[kBatch];
      float v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) e[u] = __ldg(perm + j + u);
#pragma unroll
      for (int u = 0; u < kBatch; ++u) v[u] = __ldg(data + e[u] * F + c);
#pragma unroll
      for (int u = 0; u < kBatch; ++u) acc = __fadd_rn(acc, v[u]);
    }
    for (; j < end; ++j) acc = __fadd_rn(acc, __ldg(data + __ldg(perm + j) * F + c));
    out[s * F + c] = acc;
  }
}

__global__ void __launch_bounds__(kLongThreads)
segment_sum_long_kernel(const float* __restrict__ data, const int64_t* __restrict__ perm,
                        const int64_t* __restrict__ offsets, const int64_t* __restrict__ long_ids,
                        float* __restrict__ out, int64_t F) {
  __shared__ float buf[kLongFloats];
  const int64_t s = __ldg(long_ids + blockIdx.x);
  const int64_t begin = __ldg(offsets + s);
  const int64_t end = __ldg(offsets + s + 1);
  const int t = threadIdx.x;
  for (int64_t c0 = 0; c0 < F; c0 += kLongThreads) {
    const int cw = (int)(F - c0 < kLongThreads ? F - c0 : kLongThreads);  // columns this pass
    const int rows = kLongFloats / cw;                                     // rows a chunk
    float acc = 0.0f;
    for (int64_t j0 = begin; j0 < end; j0 += rows) {
      const int k = (int)(end - j0 < rows ? end - j0 : rows);
      __syncthreads();  // the previous chunk is summed
#pragma unroll 4
      for (int i = t; i < k * cw; i += kLongThreads) {
        const int row = i / cw;
        buf[i] = __ldg(data + __ldg(perm + j0 + row) * F + c0 + (i - row * cw));
      }
      __syncthreads();
      if (t < cw) {
#pragma unroll 8
        for (int row = 0; row < k; ++row) acc = __fadd_rn(acc, buf[row * cw + t]);
      }
    }
    if (t < cw) out[s * F + c0 + t] = acc;
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launches. long_ids [n_long] are the
// segments of more than long_at edges.
int segment_sum_launch(const void* data, const void* perm, const void* offsets, const void* long_ids,
                       long long n_long, long long long_at, void* out, long long n, long long F,
                       void* stream) {
  if (n == 0 || F == 0) return (int)cudaGetLastError();
  int P = 1;
  while (P < F && P < 32) P *= 2;
  const long long per_block = (long long)kWarps * (32 / P);
  const unsigned blocks = (unsigned)((n + per_block - 1) / per_block);
  cudaStream_t st = (cudaStream_t)stream;
  segment_sum_short_kernel<<<blocks, kThreads, 0, st>>>(
      (const float*)data, (const int64_t*)perm, (const int64_t*)offsets, (float*)out, n, F, P, long_at);
  if (n_long > 0) {
    segment_sum_long_kernel<<<(unsigned)n_long, kLongThreads, 0, st>>>(
        (const float*)data, (const int64_t*)perm, (const int64_t*)offsets, (const int64_t*)long_ids,
        (float*)out, F);
  }
  return (int)cudaGetLastError();
}

const char* segment_sum_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
