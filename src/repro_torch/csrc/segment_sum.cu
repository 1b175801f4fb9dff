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
// launches give the same bits. No float atomics anywhere.
//
// What bounds it. Bytes, for a graph of short segments: every data value
// is read once and added once, one operation per 4 bytes. A hub is bound
// by its chain instead: a segment of L edges is L dependent adds a column,
// which no design may split or reassociate, so Twitter's 47,691-edge hub
// takes at least L times the add's latency, several times the whole
// product's bytes bound.
//
// Design: one kernel, one launch, roles by block.
//
// * The first blocks take the segments of more than `long_at` edges,
//   longest first (long_ids comes sorted so), one block for every 16
//   columns of one, so the longest chains start at the kernel's first
//   cycle and the short segments run beside them. A long block is
//   warp-specialised. Warps 4-7 produce: they copy the segment's rows into
//   a ring of kStages stages in shared memory with cp.async, each stage's
//   perm entries loaded three stages ahead, and hand a stage over by an
//   mbarrier that the copies themselves complete
//   (cp.async.mbarrier.arrive.noinc). A stage keeps each column's rows
//   together (4-byte copies), so that warp 0, one lane a column, reads 4
//   rows with one 16-byte load. A lane reads the next kAhead rows while it
//   adds the previous kAhead, so the chain waits on the add's latency and
//   not on shared memory, and it frees the stage by a second mbarrier. At
//   F = 4 a stage is 256 rows and the ring 1,280.
// * The other blocks take the short segments: a group of P lanes a
//   segment (32 / P segments a warp). A lane owns a float4 of the row where
//   F % 4 == 0 (else up to 4 columns, P apart), loads the perm entries of
//   kBatch edges together (predicated: a segment shorter than the batch
//   issues all its loads at once), then their rows, then adds them in edge
//   order, its 4 column chains interleaved.
//
// The static shared memory (22.5 KB) is the same for both roles, small
// enough that it never limits how many short blocks an SM holds (their
// registers do).

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;                                // a block, either role
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 8;                                    // edges a short-role lane loads before it adds them
constexpr int kSliceCols = 16;                               // long role: columns a block, one lane each
constexpr int kProducers = 128;                              // long role: threads 128-255 copy
constexpr int kStages = 5;                                   // the ring's stages
constexpr int kStageFloats = 1152;                           // 4.5 KB a stage
constexpr int kRowsMax = 256;                                // rows a stage at most: two a producer
constexpr int kAhead = 8;                                    // rows a consumer lane holds ahead of its chain
constexpr int kAheadStages = 3;                              // stages a producer loads perm entries ahead

__device__ __forceinline__ void copy4_async(uint32_t dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

// One arrival on `bar`, made when every cp.async this thread has issued
// so far has landed (counted in the barrier's expected arrivals).
__device__ __forceinline__ void copies_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// ---------------------------------------------------------------------------
// the short role
// ---------------------------------------------------------------------------
__device__ __forceinline__ void add4(float4& acc, const float4& v) {
  acc.x = __fadd_rn(acc.x, v.x);
  acc.y = __fadd_rn(acc.y, v.y);
  acc.z = __fadd_rn(acc.z, v.z);
  acc.w = __fadd_rn(acc.w, v.w);
}

// The perm entries of edges j .. j + kBatch - 1 that lie before `end`.
__device__ __forceinline__ void load_batch(const int64_t* __restrict__ perm, int64_t j, int64_t end,
                                           int64_t (&e)[kBatch]) {
#pragma unroll
  for (int u = 0; u < kBatch; ++u) e[u] = j + u < end ? __ldg(perm + j + u) : 0;
}

__device__ __forceinline__ void short_role(const float* __restrict__ data, const int64_t* __restrict__ perm,
                                           const int64_t* __restrict__ offsets, float* __restrict__ out,
                                           int64_t n, int64_t F, int P, bool vec, int64_t long_at,
                                           int64_t block) {
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
        int64_t e[kBatch];
        load_batch(perm, j, end, e);
        float4 v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          v[u] = j + u < end ? __ldg(reinterpret_cast<const float4*>(data + e[u] * F + c))
                             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (j + u < end) add4(acc, v[u]);
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
      int64_t e[kBatch];
      load_batch(perm, j, end, e);
      float v[kBatch][4];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int64_t c = c0 + k * P;
          v[u][k] = (j + u < end && c < F) ? __ldg(data + e[u] * F + c) : 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (j + u < end && c0 + k * P < F) acc[k] = __fadd_rn(acc[k], v[u][k]);
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
// Rows a stage holds for a slice of cw columns: 256, 128 or 64. A
// stage keeps each column's rows together (R rows and 4 floats of padding),
// so that a consumer lane reads 4 rows of its column with one 16-byte
// load; a column is then R + 4 = 4 (mod 32) floats long, and the lanes'
// 16-byte reads fall on distinct banks.
__device__ __forceinline__ int stage_rows(int cw) {
  const int fit = kStageFloats / cw - 4;
  int r = kRowsMax;
  while (r > 64 && r > fit) r /= 2;
  return r;
}

// Reads rows [first, first + kAhead) of a stage's column `col` into v;
// 4-row groups at or past `rows` read as 0 (a group that `rows` cuts reads
// the column's padding, which add_rows skips).
__device__ __forceinline__ void read_rows(const float* col, int first, int rows, float4 (&v)[kAhead / 4]) {
  const float4* p = reinterpret_cast<const float4*>(col + first);
  if (first + kAhead <= rows) {
#pragma unroll
    for (int q = 0; q < kAhead / 4; ++q) v[q] = p[q];
  } else {
#pragma unroll
    for (int q = 0; q < kAhead / 4; ++q) v[q] = first + 4 * q < rows ? p[q] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

__device__ __forceinline__ float add_rows(const float4 (&v)[kAhead / 4], int first, int rows, float acc) {
  if (first + kAhead <= rows) {
#pragma unroll
    for (int q = 0; q < kAhead / 4; ++q) {
      acc = __fadd_rn(acc, v[q].x);
      acc = __fadd_rn(acc, v[q].y);
      acc = __fadd_rn(acc, v[q].z);
      acc = __fadd_rn(acc, v[q].w);
    }
  } else {
#pragma unroll
    for (int q = 0; q < kAhead / 4; ++q) {
      const float e[4] = {v[q].x, v[q].y, v[q].z, v[q].w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (first + 4 * q + k < rows) acc = __fadd_rn(acc, e[k]);
      }
    }
  }
  return acc;
}

// Adds the R rows of a full stage's column to `acc` in row order. Two
// register sets take turns: the next kAhead rows are read while the
// current ones are added, so the reads hide behind the chain, and no
// register is copied (a copy would wait for its read). Unrolled whole, so
// no loop test or branch sits in the chain.
template <int R>
__device__ __forceinline__ float add_full_stage(const float* col, float acc) {
  float4 a[kAhead / 4], b[kAhead / 4];
  read_rows(col, 0, R, a);
#pragma unroll
  for (int r = 0; r < R; r += 2 * kAhead) {
    read_rows(col, r + kAhead, R, b);
    acc = add_rows(a, 0, kAhead, acc);
    if (r + 2 * kAhead < R) read_rows(col, r + 2 * kAhead, R, a);
    acc = add_rows(b, 0, kAhead, acc);
  }
  return acc;
}

// Adds `rows` rows of one stage's column to `acc` in row order: a full
// stage unrolled, a segment's last stage in the same two turns with its
// bounds tested. Every branch is the same for the whole warp.
__device__ __forceinline__ float add_stage(const float* col, int rows, int R, float acc) {
  if (rows == R) {
    switch (R) {
      case 256: return add_full_stage<256>(col, acc);
      case 128: return add_full_stage<128>(col, acc);
      default: return add_full_stage<64>(col, acc);
    }
  }
  float4 a[kAhead / 4], b[kAhead / 4];
  read_rows(col, 0, rows, a);
  for (int r = 0; r < rows; r += 2 * kAhead) {
    read_rows(col, r + kAhead, rows, b);
    acc = add_rows(a, r, rows, acc);
    read_rows(col, r + 2 * kAhead, rows, a);
    acc = add_rows(b, r + kAhead, rows, acc);
  }
  return acc;
}

// One long block: the columns [c0, c0 + cw) of one long segment, cw at most
// kSliceCols. Warp 0 adds, one lane a column; warps 4-7 copy.
__device__ __forceinline__ void long_role(const float* __restrict__ data, const int64_t* __restrict__ perm,
                                          const int64_t* __restrict__ offsets,
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
  const uint32_t empty0 = smem_u32(bars + kStages);  // empty[k]: the stage's rows were added
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
    // the consumer: one column a lane, the segment's rows in edge order
    // (lanes past cw add a copy of the last column, so the warp never splits)
    const int col = tid < cw ? tid : cw - 1;
    float acc = 0.0f;
    for (int64_t i = 0; i < stages; ++i) {
      const uint32_t slot = i % kStages;
      mbar_wait(full0 + 8 * slot, (i / kStages) & 1);
      const int rows = (int)(len - i * R < R ? len - i * R : R);
      acc = add_stage(ring + slot * kStageFloats + col * S, rows, R, acc);
      __syncwarp();
      if (tid == 0) mbar_arrive(empty0 + 8 * slot);
    }
    if (tid < cw) out[s * F + c0 + tid] = acc;
    return;
  }
  if (warp < kWarps - kProducers / 32) return;
  // a producer: T threads a row, kProducers / T rows at once, a stage in
  // at most two such rounds; a thread copies its rows' columns c_first,
  // c_first + T, ...
  const int p = tid - (kThreads - kProducers);
  const int T = R >= kProducers ? 1 : kProducers / R;
  const int c_first = p % T;
  int row[2];
  row[0] = p / T;
  row[1] = row[0] + kProducers / T;
  // perm entries (-1: no copy) are loaded kAheadStages stages before their
  // copies are issued; the loop is unrolled so that each stage's entries
  // stay in the registers they were loaded into (a move would wait for the
  // load)
  auto entries = [&](int64_t i, int64_t (&e)[2]) {
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int64_t j = i * R + row[m];
      e[m] = (row[m] < R && j < len) ? __ldg(perm + begin + j) : -1;
    }
  };
  auto step = [&](int64_t i, const int64_t (&cur)[2], int64_t (&ahead)[2]) {
    entries(i + kAheadStages, ahead);
    const uint32_t slot = i % kStages;
    mbar_wait(empty0 + 8 * slot, ((i / kStages) & 1) ^ 1);
    const uint32_t st = smem_u32(ring + slot * kStageFloats);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      if (cur[m] < 0) continue;
      const float* src = data + cur[m] * F + c0;
      for (int c = c_first; c < cw; c += T) copy4_async(st + 4u * (uint32_t)(c * S + row[m]), src + c);
    }
    copies_arrive(full0 + 8 * slot);
  };
  static_assert(kAheadStages == 3, "the unrolled loop below rotates 4 sets of entries");
  int64_t e0[2], e1[2], e2[2], e3[2];
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
segment_sum_kernel(const float* __restrict__ data, const int64_t* __restrict__ perm,
                   const int64_t* __restrict__ offsets, const int64_t* __restrict__ long_ids,
                   float* __restrict__ out, int64_t n, int64_t F, int P, int vec, int64_t n_long,
                   int slices, int64_t long_at) {
  __shared__ __align__(128) float ring[kStages * kStageFloats];
  __shared__ __align__(8) uint64_t bars[2 * kStages];
  const int64_t block = blockIdx.x;
  if (block < n_long * slices) {
    long_role(data, perm, offsets, long_ids, out, F, block, slices, ring, bars);
  } else {
    short_role(data, perm, offsets, out, n, F, P, vec != 0, long_at, block - n_long * slices);
  }
}

// The latency of one dependent __fadd_rn, for the chain floor: one thread
// adds `n` times in a chain between two clock reads. out = {cycles, ns,
// the sum}.
__global__ void add_chain_probe_kernel(float x, int n, long long* out) {
  float acc = x;
  uint64_t g0, g1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0));
  const long long t0 = clock64();
  asm volatile("" : "+f"(acc));
  for (int i = 0; i < n; i += 64) {
#pragma unroll
    for (int u = 0; u < 64; ++u) acc = __fadd_rn(acc, x);
  }
  asm volatile("" : "+f"(acc));
  const long long t1 = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1));
  out[0] = t1 - t0;
  out[1] = (long long)(g1 - g0);
  out[2] = (long long)acc;
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch. long_ids [n_long] are the
// segments of more than long_at edges, longest first.
int segment_sum_launch(const void* data, const void* perm, const void* offsets, const void* long_ids,
                       long long n_long, long long long_at, void* out, long long n, long long F,
                       void* stream) {
  if (n == 0 || F == 0) return (int)cudaGetLastError();
  const int vec = F % 4 == 0 && (uintptr_t)data % 16 == 0;
  const long long slots = vec ? F / 4 : F;  // a row's float4s, or its floats
  int P = 1;
  while (P < slots && P < 32) P *= 2;
  const long long per_block = (long long)kWarps * (32 / P);
  const int slices = (int)((F + kSliceCols - 1) / kSliceCols);  // long blocks a long segment
  const long long blocks = n_long * slices + (n + per_block - 1) / per_block;
  segment_sum_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)data, (const int64_t*)perm, (const int64_t*)offsets, (const int64_t*)long_ids,
      (float*)out, n, F, P, vec, n_long, slices, long_at);
  return (int)cudaGetLastError();
}

// Writes {cycles, ns, the sum} of `n` dependent adds by one thread to out
// (3 int64 on the card). Not a segment sum: the chain floor's measurement.
int segment_sum_add_probe(void* out, long long n, void* stream) {
  add_chain_probe_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(1.0f, (int)n, (long long*)out);
  return (int)cudaGetLastError();
}

const char* segment_sum_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
