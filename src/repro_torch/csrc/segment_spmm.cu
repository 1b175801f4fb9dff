// segment_spmm: a float32 CSR product in a fixed order, for Hopper (sm_90a):
// DiDiC's diffusion product A_c @ X at every scale.
//
// Replaces no Pallas kernel. It carries bell_matmul's function (A_c @ W,
// src/repro/kernels/bsr_spmm/kernel.py:52, ported as bell_matmul.cu) where
// the block-ELL packing cannot go: that packing keeps vertex ids, so a
// 128-row block's neighbours spread over the whole id range and the
// paper's graphs at scale 1.0 would take ~100 GB of blocks. The JAX package
// computes the product there as ce[:, None] * take(x, r) followed by
// jax.ops.segment_sum (src/repro/core/didic.py:127); this kernel computes
// it in one pass:
//
//   out[s, c] = sum over e in [offsets[s], offsets[s + 1]) of scale[e] * x[col[e], c]
//
// with x [N, F] float32, the edges sorted by output row s (CSR): col [E]
// int32, scale [E] float32 and offsets [n + 1] int64. A row with no edge
// gets 0 (the capacity overlay's dead rows past n_nodes).
//
// The order. Each term is one __fmul_rn; each row's terms are added one
// after another, in ascending edge id, starting from +0.0, with __fadd_rn
// (no FMA contraction, no split or re-associated chain, no float atomics).
// That is the order of the plain version on the CPU, index_add_ of
// scale[:, None] * x[col] into zeros (and of XLA's scatter-add on the CPU),
// so the card's product equals it bit for bit and two launches give the
// same bits.
//
// What bounds it. Bytes: col and scale are read once, x's rows once each
// (a row is fetched by every edge that reaches it, mostly from L2), the
// offsets once and out written once; one multiply and one add for every 8
// bytes of edge data. On Twitter the 47,691-edge hub bounds it instead: its
// row is 47,691 dependent adds a column, which no design may split, so it
// takes at least that many times the add's latency (~0.098 ms at 1.98 GHz),
// several times the whole product's bytes bound.
//
// Design: segment_sum.cu's two roles in one launch, the rows fetched as
// x[col[e]] and scaled by scale[e] rather than read as data[perm[e]] (the
// edges of a row are contiguous, so there is no permutation).
//
// * The first blocks take the rows of more than `long_at` edges, longest
//   first (long_ids comes sorted so), one block for every 16 columns of one,
//   so the longest chains start at the kernel's first cycle and the short
//   rows run beside them. Warps 4-7 produce: they copy the rows x[col[e]]
//   and the scales into a ring of kStages stages in shared memory with
//   cp.async, each stage's col entries loaded three stages ahead, and hand
//   a stage over by an mbarrier that the copies themselves complete. A
//   stage keeps each column's rows together, and the scales as one more
//   column, so that warp 0, one lane a column, reads 4 rows and their 4
//   scales with two 16-byte loads (the scales' address is the same for
//   every lane: a broadcast). A lane reads the next kAhead rows while it
//   multiplies and adds the previous kAhead, so the chain waits on the
//   add's latency and not on shared memory. At F = 4 a stage is 256 rows.
// * The other blocks take the short rows: a group of P lanes a row (at
//   F = 4 one lane, 32 rows a warp). A lane owns a float4 of the row where
//   F % 4 == 0 (else up to 4 columns, P apart), loads the col entries and
//   scales of kBatch edges together (predicated: a row shorter than the
//   batch issues all its loads at once), then their x rows, then multiplies
//   and adds them in edge order, its 4 column chains interleaved.

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;                                // a block, either role
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 8;                                    // edges a short-role lane loads before it adds them
constexpr int kSliceCols = 16;                               // long role: columns a block, one lane each
constexpr int kProducers = 128;                              // long role: threads 128-255 copy
constexpr int kStages = 5;                                   // the ring's stages
constexpr int kStageFloats = 1312;                           // 5.1 KB a stage: (columns + scales) x (rows + 4)
constexpr int kRowsMax = 256;                                // rows a stage at most: two a producer
constexpr int kAhead = 8;                                    // rows a consumer lane holds ahead of its chain
constexpr int kAheadStages = 3;                              // stages a producer loads col entries ahead

__device__ __forceinline__ void copy4_async(uint32_t dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

// One arrival on `bar`, made when every cp.async this thread has issued
// so far has landed (counted in the barrier's expected arrivals).
__device__ __forceinline__ void copies_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// acc + w * v, a column at a time: the product rounded, then the sum.
__device__ __forceinline__ float term(float acc, float w, float v) {
  return __fadd_rn(acc, __fmul_rn(w, v));
}

// ---------------------------------------------------------------------------
// the short role
// ---------------------------------------------------------------------------
// The col entries and scales of edges j .. j + kBatch - 1 that lie before `end`.
__device__ __forceinline__ void load_batch(const int* __restrict__ col, const float* __restrict__ scale, int64_t j,
                                           int64_t end, int (&e)[kBatch], float (&w)[kBatch]) {
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    e[u] = j + u < end ? __ldg(col + j + u) : 0;
    w[u] = j + u < end ? __ldg(scale + j + u) : 0.0f;
  }
}

__device__ __forceinline__ void short_role(const float* __restrict__ x, const int* __restrict__ col,
                                           const float* __restrict__ scale, const int64_t* __restrict__ offsets,
                                           float* __restrict__ out, int64_t n, int64_t F, int P, bool vec,
                                           int64_t long_at, int64_t block) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int groups = 32 / P;
  const int g = lane / P;
  const int p = lane - g * P;
  const int64_t s = (block * kWarps + warp) * groups + g;
  if (s >= n) return;  // no warp-wide primitive follows
  const int64_t begin = __ldg(offsets + s);
  const int64_t end = __ldg(offsets + s + 1);
  if (end - begin > long_at) return;  // a long block's
  if (vec) {
    for (int64_t c = 4 * (int64_t)p; c < F; c += 4 * (int64_t)P) {
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int64_t j = begin; j < end; j += kBatch) {
        int e[kBatch];
        float w[kBatch];
        load_batch(col, scale, j, end, e, w);
        float4 v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          v[u] = j + u < end ? __ldg(reinterpret_cast<const float4*>(x + (int64_t)e[u] * F + c))
                             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (j + u < end) {
            acc.x = term(acc.x, w[u], v[u].x);
            acc.y = term(acc.y, w[u], v[u].y);
            acc.z = term(acc.z, w[u], v[u].z);
            acc.w = term(acc.w, w[u], v[u].w);
          }
        }
      }
      *reinterpret_cast<float4*>(out + s * F + c) = acc;
    }
    return;
  }
  // 4-byte columns: up to 4 of them a lane a walk, P apart
  for (int64_t c0 = p; c0 < F; c0 += 4 * (int64_t)P) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int64_t j = begin; j < end; j += kBatch) {
      int e[kBatch];
      float w[kBatch];
      load_batch(col, scale, j, end, e, w);
      float v[kBatch][4];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int64_t c = c0 + k * P;
          v[u][k] = (j + u < end && c < F) ? __ldg(x + (int64_t)e[u] * F + c) : 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (j + u < end && c0 + k * P < F) acc[k] = term(acc[k], w[u], v[u][k]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (c0 + k * P < F) out[s * F + c0 + k * P] = acc[k];
    }
  }
}

// ---------------------------------------------------------------------------
// the long role
// ---------------------------------------------------------------------------
// Rows a stage holds for a slice of cw columns: 256, 128 or 64. A stage
// keeps each column's rows together (R rows and 4 floats of padding), then
// the scales as column cw, so that a consumer lane reads 4 rows of its
// column with one 16-byte load; a column is then R + 4 = 4 (mod 32) floats
// long, and the lanes' 16-byte reads fall on distinct banks.
__device__ __forceinline__ int stage_rows(int cw) {
  const int fit = kStageFloats / (cw + 1) - 4;
  int r = kRowsMax;
  while (r > 64 && r > fit) r /= 2;
  return r;
}

// Reads rows [first, first + kAhead) of a stage's column `xs` and of its
// scales `ws` into v and w; 4-row groups at or past `rows` read as 0 (a
// group that `rows` cuts reads the columns' padding, which add_rows skips).
__device__ __forceinline__ void read_rows(const float* xs, const float* ws, int first, int rows,
                                          float4 (&v)[kAhead / 4], float4 (&w)[kAhead / 4]) {
  const float4* pv = reinterpret_cast<const float4*>(xs + first);
  const float4* pw = reinterpret_cast<const float4*>(ws + first);
  if (first + kAhead <= rows) {
#pragma unroll
    for (int q = 0; q < kAhead / 4; ++q) {
      v[q] = pv[q];
      w[q] = pw[q];
    }
  } else {
#pragma unroll
    for (int q = 0; q < kAhead / 4; ++q) {
      const bool in = first + 4 * q < rows;
      v[q] = in ? pv[q] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      w[q] = in ? pw[q] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
}

__device__ __forceinline__ float add_rows(const float4 (&v)[kAhead / 4], const float4 (&w)[kAhead / 4], int first,
                                          int rows, float acc) {
  if (first + kAhead <= rows) {
#pragma unroll
    for (int q = 0; q < kAhead / 4; ++q) {
      acc = term(acc, w[q].x, v[q].x);
      acc = term(acc, w[q].y, v[q].y);
      acc = term(acc, w[q].z, v[q].z);
      acc = term(acc, w[q].w, v[q].w);
    }
  } else {
#pragma unroll
    for (int q = 0; q < kAhead / 4; ++q) {
      const float ev[4] = {v[q].x, v[q].y, v[q].z, v[q].w};
      const float ew[4] = {w[q].x, w[q].y, w[q].z, w[q].w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (first + 4 * q + k < rows) acc = term(acc, ew[k], ev[k]);
      }
    }
  }
  return acc;
}

// Adds the R terms of a full stage's column to `acc` in row order. Two
// register sets take turns: the next kAhead rows are read while the
// current ones are multiplied and added, so the reads hide behind the
// chain. Unrolled whole, so no loop test or branch sits in the chain.
template <int R>
__device__ __forceinline__ float add_full_stage(const float* xs, const float* ws, float acc) {
  float4 a[kAhead / 4], aw[kAhead / 4], b[kAhead / 4], bw[kAhead / 4];
  read_rows(xs, ws, 0, R, a, aw);
#pragma unroll
  for (int r = 0; r < R; r += 2 * kAhead) {
    read_rows(xs, ws, r + kAhead, R, b, bw);
    acc = add_rows(a, aw, 0, kAhead, acc);
    if (r + 2 * kAhead < R) read_rows(xs, ws, r + 2 * kAhead, R, a, aw);
    acc = add_rows(b, bw, 0, kAhead, acc);
  }
  return acc;
}

// Adds `rows` terms of one stage's column to `acc` in row order: a full
// stage unrolled, a row's last stage in the same two turns with its bounds
// tested. Every branch is the same for the whole warp.
__device__ __forceinline__ float add_stage(const float* xs, const float* ws, int rows, int R, float acc) {
  if (rows == R) {
    switch (R) {
      case 256: return add_full_stage<256>(xs, ws, acc);
      case 128: return add_full_stage<128>(xs, ws, acc);
      default: return add_full_stage<64>(xs, ws, acc);
    }
  }
  float4 a[kAhead / 4], aw[kAhead / 4], b[kAhead / 4], bw[kAhead / 4];
  read_rows(xs, ws, 0, rows, a, aw);
  for (int r = 0; r < rows; r += 2 * kAhead) {
    read_rows(xs, ws, r + kAhead, rows, b, bw);
    acc = add_rows(a, aw, r, rows, acc);
    read_rows(xs, ws, r + 2 * kAhead, rows, a, aw);
    acc = add_rows(b, bw, r + kAhead, rows, acc);
  }
  return acc;
}

// One long block: the columns [c0, c0 + cw) of one long row, cw at most
// kSliceCols. Warp 0 multiplies and adds, one lane a column; warps 4-7 copy.
__device__ __forceinline__ void long_role(const float* __restrict__ x, const int* __restrict__ col,
                                          const float* __restrict__ scale, const int64_t* __restrict__ offsets,
                                          const int64_t* __restrict__ long_ids, float* __restrict__ out,
                                          int64_t F, int64_t block, int slices, float* ring, uint64_t* bars) {
  const int64_t s = __ldg(long_ids + block / slices);
  const int64_t c0 = (block % slices) * (int64_t)kSliceCols;
  const int cw = (int)(F - c0 < kSliceCols ? F - c0 : kSliceCols);
  const int64_t begin = __ldg(offsets + s);
  const int64_t len = __ldg(offsets + s + 1) - begin;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const uint32_t full0 = smem_u32(bars);             // full[k]: the stage's copies landed
  const uint32_t empty0 = smem_u32(bars + kStages);  // empty[k]: the stage's terms were added
  if (tid == 0) {
    for (int k = 0; k < kStages; ++k) {
      mbar_init(full0 + 8 * k, kProducers);
      mbar_init(empty0 + 8 * k, 1);
    }
  }
  __syncthreads();
  const int R = stage_rows(cw);   // rows a stage
  const int S = R + 4;            // floats a column of a stage
  const int64_t stages = (len + R - 1) / R;
  if (warp == 0) {
    // the consumer: one column a lane, the row's terms in edge order (lanes
    // past cw add a copy of the last column, so the warp never splits)
    const int c = tid < cw ? tid : cw - 1;
    float acc = 0.0f;
    for (int64_t i = 0; i < stages; ++i) {
      const uint32_t slot = i % kStages;
      mbar_wait(full0 + 8 * slot, (i / kStages) & 1);
      const int rows = (int)(len - i * R < R ? len - i * R : R);
      const float* st = ring + slot * kStageFloats;
      acc = add_stage(st + c * S, st + cw * S, rows, R, acc);
      __syncwarp();
      if (tid == 0) mbar_arrive(empty0 + 8 * slot);
    }
    if (tid < cw) out[s * F + c0 + tid] = acc;
    return;
  }
  if (warp < kWarps - kProducers / 32) return;
  // a producer: T threads a row, kProducers / T rows at once, a stage in
  // at most two such rounds; a thread copies its rows' columns c_first,
  // c_first + T, ..., and the thread with c_first 0 the row's scale
  const int p = tid - (kThreads - kProducers);
  const int T = R >= kProducers ? 1 : kProducers / R;
  const int c_first = p % T;
  int row[2];
  row[0] = p / T;
  row[1] = row[0] + kProducers / T;
  // col entries (-1: no copy) are loaded kAheadStages stages before their
  // copies are issued; the loop is unrolled so that each stage's entries
  // stay in the registers they were loaded into (a move would wait for the
  // load)
  auto entries = [&](int64_t i, int (&e)[2]) {
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int64_t j = i * R + row[m];
      e[m] = (row[m] < R && j < len) ? __ldg(col + begin + j) : -1;
    }
  };
  auto step = [&](int64_t i, const int (&cur)[2], int (&ahead)[2]) {
    entries(i + kAheadStages, ahead);
    const uint32_t slot = i % kStages;
    mbar_wait(empty0 + 8 * slot, ((i / kStages) & 1) ^ 1);
    const uint32_t st = smem_u32(ring + slot * kStageFloats);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      if (cur[m] < 0) continue;
      const float* src = x + (int64_t)cur[m] * F + c0;
      for (int c = c_first; c < cw; c += T) copy4_async(st + 4u * (uint32_t)(c * S + row[m]), src + c);
      if (c_first == 0) copy4_async(st + 4u * (uint32_t)(cw * S + row[m]), scale + begin + i * R + row[m]);
    }
    copies_arrive(full0 + 8 * slot);
  };
  static_assert(kAheadStages == 3, "the unrolled loop below rotates 4 sets of entries");
  int e0[2], e1[2], e2[2], e3[2];
  entries(0, e0);
  entries(1, e1);
  entries(2, e2);
  for (int64_t i = 0; i < stages; i += 4) {
    step(i, e0, e3);
    if (i + 1 < stages) step(i + 1, e1, e0);
    if (i + 2 < stages) step(i + 2, e2, e1);
    if (i + 3 < stages) step(i + 3, e3, e2);
  }
}

__global__ void __launch_bounds__(kThreads)
segment_spmm_kernel(const float* __restrict__ x, const int* __restrict__ col, const float* __restrict__ scale,
                    const int64_t* __restrict__ offsets, const int64_t* __restrict__ long_ids,
                    float* __restrict__ out, int64_t n, int64_t F, int P, int vec, int64_t n_long, int slices,
                    int64_t long_at) {
  __shared__ __align__(128) float ring[kStages * kStageFloats];
  __shared__ __align__(8) uint64_t bars[2 * kStages];
  const int64_t block = blockIdx.x;
  if (block < n_long * slices) {
    long_role(x, col, scale, offsets, long_ids, out, F, block, slices, ring, bars);
  } else {
    short_role(x, col, scale, offsets, out, n, F, P, vec != 0, long_at, block - n_long * slices);
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch. long_ids [n_long] are the
// rows of more than long_at edges, longest first.
int segment_spmm_launch(const void* x, const void* col, const void* scale, const void* offsets,
                        const void* long_ids, long long n_long, long long long_at, void* out, long long n,
                        long long F, void* stream) {
  if (n == 0 || F == 0) return (int)cudaGetLastError();
  const int vec = F % 4 == 0 && (uintptr_t)x % 16 == 0;
  const long long slots = vec ? F / 4 : F;  // a row's float4s, or its floats
  int P = 1;
  while (P < slots && P < 32) P *= 2;
  const long long per_block = (long long)kWarps * (32 / P);
  const int slices = (int)((F + kSliceCols - 1) / kSliceCols);  // long blocks a long row
  const long long blocks = n_long * slices + (n + per_block - 1) / per_block;
  segment_spmm_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const int*)col, (const float*)scale, (const int64_t*)offsets, (const int64_t*)long_ids,
      (float*)out, n, F, P, vec, n_long, slices, long_at);
  return (int)cudaGetLastError();
}

const char* segment_spmm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
