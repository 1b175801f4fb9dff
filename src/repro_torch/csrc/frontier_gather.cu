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
// shortest-path replay. Its min is jnp.minimum's and torch.minimum's: NaN
// wherever any x[nbr[v, j], c] + w[v, j] is NaN (-inf + +inf included),
// which fminf would drop.
//
// What bounds it: bytes. Each output element costs D gathered loads and D
// adds and mins; the card does about 20 float operations per byte of
// device memory, so at D below ten the gathers of x rows, plus reading nbr
// and w and writing out, set the time. The least traffic is reading x,
// nbr and w once and writing out once. On the GIS replay's whole-graph
// layout (786,432 rows, C = 128, 512-byte rows) x is 402 MB: a row read
// by its ~5 in-neighbour rows comes from device memory once only if those
// readers run while the row is still in the 50 MB L2.
//
// Design.
//   * A row schedule. `order` (int32 [V], a permutation of the rows, or
//     null for 0..V-1) lists the rows in the order blocks take them; each
//     row is still written to its own place in `out`. The GIS engine passes
//     the rows along a Hilbert curve over the vertices' coordinates, so the
//     rows in flight at any moment, and the x rows they read, come from one
//     small region of the map and each x row is reused from L2. Vertex ids
//     are random in space, so without it almost every gather misses L2.
//   * A warp owns one output row. Its lanes read the row's slot ids and
//     weights together (one coalesced, evict-first load of nbr and of w per
//     row) and pass them on by shuffle. A lane covers 4 consecutive columns
//     (one pass of the warp covers 128) when C % 4 == 0 and x and out are
//     16-byte aligned: it copies its 16 bytes of the next 4 slots' x rows
//     into the warp's landing buffer in shared memory with cp.async, waits
//     once and reduces from there, so the copies cost no registers and a
//     block of 4 warps needs 32 registers a thread and 8 KB: the SM holds
//     its full 64 warps. Otherwise a lane covers one column with scalar
//     loads (32 a pass). Wider C takes more passes.
//   * `out` is written with evict-first stores (st.global.cs), so the 402
//     MB of output do not push x out of L2.
//   * The spill tail (over-cap in-edges, CSR by row) is folded in by a
//     second kernel of the same call, one warp per row that has a tail
//     (51,256 of 786,432 on the GIS layout), after the padded slots: min is
//     exact in any order, and sum adds the tail after the slots.
// What was tried, on the GIS layout at C = 128 (NVIDIA H100 80GB HBM3,
// timed with kernel_ab.py and chip_smoke.py): the first design (one thread
// per (row, column), a serial slot loop) took 0.95 ms a call back to back,
// every gather missing L2; this one takes 0.48 with the schedule and 0.75
// without. On the way, with the schedule in place, every change that cost
// registers lost more than it won, since fewer warps fit on an SM: 8 slots'
// x rows held in registers, the tail read in the same kernel, warps that
// walk many rows and fetch the next row's slots early, and skipping
// repeated (sender, weight) slots in min mode; so did loads that bypass L1
// (ld.global.cg: every padded slot reads row 0 of x, which L1 keeps) and
// prefetching the slots of rows further down the schedule into L2. What
// won was the fewest registers a warp: 4 slots in flight through the
// cp.async landing buffer. Hopper's TMA has no gather mode (its tiles are
// boxes of a tensor, not lists of rows), and its 1-D bulk copies bypass L1
// as ld.global.cg does.
//
// Min mode is bit-exact against any other evaluation order: it uses one
// correctly rounded add (__fadd_rn, never contracted into an FMA) and a
// min, both exact in any order; +inf padding stays +inf. Sum mode adds the
// slots in slot order with FMA; its tolerance is 1e-5.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;             // rows (one a warp) a block
constexpr int kThreads = 32 * kWarps;
constexpr int kBatch = 4;             // slots whose x rows a warp has in flight at once

// torch.minimum / jnp.minimum: NaN in either argument gives NaN.
__device__ __forceinline__ float min_nan(float acc, float v) {
  return (v < acc || v != v) ? v : acc;
}

template <bool kMin>
__device__ __forceinline__ float combine(float acc, float xv, float wv) {
  return kMin ? min_nan(acc, __fadd_rn(xv, wv)) : fmaf(wv, xv, acc);
}

template <int kVec>
__device__ __forceinline__ void store_out(float* p, const float (&v)[kVec]) {
  if constexpr (kVec == 4) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else {
    __stcs(p, v[0]);
  }
}

// 16 bytes from global to shared memory without passing through registers
// (cached in L1 as well: the padded slots all read row 0 of x).
__device__ __forceinline__ void copy16_async(void* smem, const float* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

// Folds `count` slots (senders ids[0..count), weights ws[..]) into this
// lane's columns c .. c + kVec - 1, in slot order. The lanes read 32 slots'
// ids and weights with one coalesced, evict-first load each and pass them
// on by shuffle. On the 16-byte path every lane copies its 16 bytes of the
// next kBatch x rows into the warp's landing buffer in shared memory with
// cp.async, waits once, and reduces from there: the rows are in flight
// together at no cost in registers, which keeps the SM full of warps.
template <bool kMin, int kVec>
__device__ __forceinline__ void add_slots(const float* __restrict__ x, const int32_t* __restrict__ ids,
                                          const float* __restrict__ ws, int64_t count, int64_t C,
                                          int64_t c, bool active, int lane, float4 (&land)[kBatch][32],
                                          float (&acc)[kVec]) {
  for (int64_t j0 = 0; j0 < count; j0 += 32) {
    const int jn = (int)(count - j0 < 32 ? count - j0 : 32);
    int32_t my_n = 0;
    float my_w = 0.0f;
    if (lane < jn) {
      my_n = __ldcs(ids + j0 + lane);
      my_w = __ldcs(ws + j0 + lane);
    }
    for (int jj = 0; jj < jn; jj += kBatch) {
      float xv[kBatch][kVec];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int32_t n = __shfl_sync(0xffffffffu, my_n, (jj + u) & 31);
        if (active && jj + u < jn) {
          if constexpr (kVec == 4) {
            copy16_async(&land[u][lane], x + (int64_t)n * C + c);
          } else {
            xv[u][0] = __ldg(x + (int64_t)n * C + c);
          }
        }
      }
      if constexpr (kVec == 4) asm volatile("cp.async.wait_all;\n" ::: "memory");
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const float wv = __shfl_sync(0xffffffffu, my_w, (jj + u) & 31);
        if (active && jj + u < jn) {
          if constexpr (kVec == 4) {
            const float4 t = land[u][lane];
            xv[u][0] = t.x; xv[u][1] = t.y; xv[u][2] = t.z; xv[u][3] = t.w;
          }
#pragma unroll
          for (int k = 0; k < kVec; ++k) acc[k] = combine<kMin>(acc[k], xv[u][k], wv);
        }
      }
    }
  }
}

// One warp per row: rows order[i] (or i) in schedule order, each written to
// its own place in out.
template <bool kMin, int kVec>
__global__ void __launch_bounds__(kThreads)
frontier_gather_kernel(const float* __restrict__ x, const int32_t* __restrict__ nbr,
                       const float* __restrict__ w, const int32_t* __restrict__ order,
                       float* __restrict__ out, int64_t V, int64_t D, int64_t C) {
  __shared__ float4 land[kWarps][kBatch][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t i = (int64_t)blockIdx.x * kWarps + warp;
  if (i >= V) return;  // the whole warp leaves together
  const int64_t v = order != nullptr ? (int64_t)__ldg(order + i) : i;
  constexpr int kCols = 32 * kVec;  // columns one pass of the warp covers
  for (int64_t c0 = 0; c0 < C; c0 += kCols) {
    const int64_t c = c0 + (int64_t)lane * kVec;
    const bool active = c < C;
    float acc[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) acc[k] = kMin ? INFINITY : 0.0f;
    add_slots<kMin, kVec>(x, nbr + v * D, w + v * D, D, C, c, active, lane, land[warp], acc);
    if (active) store_out<kVec>(out + v * C + c, acc);
  }
}

// The spill tail: one warp per row that has one (rows[r]), folding its
// tail slots into what the main kernel wrote, after the padded slots.
template <bool kMin, int kVec>
__global__ void __launch_bounds__(kThreads)
frontier_tail_kernel(const float* __restrict__ x, const int32_t* __restrict__ rows, int64_t R,
                     const int32_t* __restrict__ tail_ptr, const int32_t* __restrict__ tail_src,
                     const float* __restrict__ tail_w, float* __restrict__ out, int64_t C) {
  __shared__ float4 land[kWarps][kBatch][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * kWarps + warp;
  if (r >= R) return;
  const int64_t v = __ldg(rows + r);
  const int64_t t0 = __ldg(tail_ptr + v);
  const int64_t t1 = __ldg(tail_ptr + v + 1);
  constexpr int kCols = 32 * kVec;
  for (int64_t c0 = 0; c0 < C; c0 += kCols) {
    const int64_t c = c0 + (int64_t)lane * kVec;
    const bool active = c < C;
    float acc[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) acc[k] = active ? out[v * C + c + k] : 0.0f;
    add_slots<kMin, kVec>(x, tail_src + t0, tail_w + t0, t1 - t0, C, c, active, lane, land[warp], acc);
    if (active) store_out<kVec>(out + v * C + c, acc);
  }
}

template <bool kMin, int kVec>
void launch(const float* x, const int32_t* nbr, const float* w, const int32_t* order,
            const int32_t* tail_rows, int64_t R, const int32_t* tail_ptr, const int32_t* tail_src,
            const float* tail_w, float* out, int64_t V, int64_t D, int64_t C, cudaStream_t s) {
  frontier_gather_kernel<kMin, kVec><<<(unsigned)((V + kWarps - 1) / kWarps), kThreads, 0, s>>>(
      x, nbr, w, order, out, V, D, C);
  if (R > 0) {
    frontier_tail_kernel<kMin, kVec><<<(unsigned)((R + kWarps - 1) / kWarps), kThreads, 0, s>>>(
        x, tail_rows, R, tail_ptr, tail_src, tail_w, out, C);
  }
}

}  // namespace

extern "C" {

// mode: 0 = sum, 1 = min. `order` may be null (rows in index order). The
// spill tail is tail_rows [R] (rows that have one), tail_ptr [V + 1],
// tail_src / tail_w [S]; R = 0 when there is none. Returns
// cudaGetLastError() after the launches.
int frontier_gather_launch(const void* x, const void* nbr, const void* w, const void* order,
                           const void* tail_rows, long long R, const void* tail_ptr,
                           const void* tail_src, const void* tail_w, void* out, long long V,
                           long long D, long long C, int mode, void* stream) {
  if (V == 0 || C == 0) return (int)cudaGetLastError();
  const auto* xp = (const float*)x;
  const auto* np = (const int32_t*)nbr;
  const auto* wp = (const float*)w;
  const auto* op = (const int32_t*)order;
  const auto* tr = (const int32_t*)tail_rows;
  const auto* tp = (const int32_t*)tail_ptr;
  const auto* ts = (const int32_t*)tail_src;
  const auto* tw = (const float*)tail_w;
  auto* outp = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = C % 4 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)out % 16 == 0;
  if (mode == 1) {
    if (vec) launch<true, 4>(xp, np, wp, op, tr, R, tp, ts, tw, outp, V, D, C, s);
    else launch<true, 1>(xp, np, wp, op, tr, R, tp, ts, tw, outp, V, D, C, s);
  } else {
    if (vec) launch<false, 4>(xp, np, wp, op, tr, R, tp, ts, tw, outp, V, D, C, s);
    else launch<false, 1>(xp, np, wp, op, tr, R, tp, ts, tw, outp, V, D, C, s);
  }
  return (int)cudaGetLastError();
}

const char* frontier_gather_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
