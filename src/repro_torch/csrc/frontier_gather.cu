// frontier_gather: padded in-neighbour gather-reduce, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `frontier_gather` in
// src/repro/kernels/frontier/kernel.py (bodies `_frontier_sum_kernel` and
// `_frontier_min_kernel`):
//
//   sum mode:  out[v, c] = sum_j w[v, j] * x[nbr[v, j], c]
//   min mode:  out[v, c] = min_j (x[nbr[v, j], c] + w[v, j])   (w = +inf pads)
//
// with x [N, C] float32 (vertex-major, C batched operations), nbr [V, D]
// int32 and w [V, D] float32. Min mode is one relaxation sweep of the GIS
// shortest-path replay.
//
// What bounds it: bytes. Each output element costs D gathered loads and D
// adds and mins; the card does about 20 float operations per byte of
// device memory, so at D below ten the gathers of x rows, plus reading nbr
// and w and writing out, set the time. The least traffic is reading x once
// (when rows are shared, the L2 cache can serve repeats), nbr and w once
// and writing out once.
//
// Design. The TPU kernel walks a grid (v, c tile, d) with the slot axis d
// innermost and sequential, keeping the output tile resident while it
// accumulates. Here one thread owns one (row, column) output: blocks own a
// few rows, threads own up to 128 consecutive columns, so a warp reads 32
// neighbouring floats of one x row (128 contiguous bytes) per slot. The
// slot loop runs inside the thread (it takes the place of the TPU's
// sequential d axis) and keeps the accumulator in a register; nbr[v, j]
// and w[v, j] are the same address for the whole warp, so each costs one
// broadcast load. No atomics, no shared memory.
//
// Min mode is bit-exact against any other evaluation order: it uses one
// correctly rounded add (__fadd_rn, never contracted into an FMA) and a
// min, both exact in any order; +inf padding stays +inf. Sum mode may use
// FMA; its tolerance is 1e-5. A column count that is not a multiple of the
// tile, or wider than one tile, is handled by masking the ragged edge.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <bool kMin>
__global__ void __launch_bounds__(kThreads)
frontier_gather_kernel(const float* __restrict__ x, const int32_t* __restrict__ nbr,
                       const float* __restrict__ w, float* __restrict__ out,
                       int64_t V, int64_t D, int64_t C, int c_tile) {
  const int64_t v = (int64_t)blockIdx.x * blockDim.y + threadIdx.y;
  const int64_t c = (int64_t)blockIdx.y * c_tile + threadIdx.x;
  if (v >= V || c >= C) return;
  const int32_t* nrow = nbr + v * D;
  const float* wrow = w + v * D;
  float acc = kMin ? INFINITY : 0.0f;
  for (int64_t j = 0; j < D; ++j) {
    const float wv = __ldg(wrow + j);
    const float xv = __ldg(x + (int64_t)__ldg(nrow + j) * C + c);
    if (kMin) {
      acc = fminf(acc, __fadd_rn(xv, wv));
    } else {
      acc = fmaf(wv, xv, acc);
    }
  }
  out[v * C + c] = acc;
}

}  // namespace

extern "C" {

// mode: 0 = sum, 1 = min. Returns cudaGetLastError() after the launch.
int frontier_gather_launch(const void* x, const void* nbr, const void* w, void* out,
                           long long V, long long D, long long C, int mode, void* stream) {
  if (V == 0 || C == 0) return (int)cudaGetLastError();
  const int c_tile = C >= 128 ? 128 : (int)((C + 31) / 32) * 32;
  const int rows = kThreads / c_tile;
  const dim3 block(c_tile, rows);
  const dim3 grid((unsigned)((V + rows - 1) / rows), (unsigned)((C + c_tile - 1) / c_tile));
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == 1) {
    frontier_gather_kernel<true><<<grid, block, 0, s>>>(
        (const float*)x, (const int32_t*)nbr, (const float*)w, (float*)out, V, D, C, c_tile);
  } else {
    frontier_gather_kernel<false><<<grid, block, 0, s>>>(
        (const float*)x, (const int32_t*)nbr, (const float*)w, (float*)out, V, D, C, c_tile);
  }
  return (int)cudaGetLastError();
}

const char* frontier_gather_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
