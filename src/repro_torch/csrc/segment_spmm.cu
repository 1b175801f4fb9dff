// segment_spmm: a float32 CSR product in a fixed order, for Hopper (sm_90a):
// DiDiC's diffusion product A_c @ X at every scale, with DiDiC's update of
// each step applied to the finished rows in the same launch.
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
//   acc[s, c] = sum over e in [offsets[s], offsets[s + 1]) of scale[e] * x[col[e], c]
//
// with x [N, F] float32, the edges sorted by output row s (CSR): col [E]
// int32, scale [E] float32 and offsets [n + 1] (int32 where E < 2^31, else
// int64). A row with no edge gets 0 (the capacity overlay's dead rows past
// n_nodes). The row's writer then applies an epilogue, DiDiC's update around
// the product (src/repro/core/didic.py:205-206, :211, :219), each operation
// rounded once, in the order of the eager expression (x is the product's
// input, so n == N; d a [n] vector):
//
//   none       out = acc
//   secondary  out = (l - d * x) + acc,  out2 = out / b   (x = l / b, b = member where
//              the row is live and c == parts[s], else 1: the next step's input)
//   primary    out = ((x + l) - d * x) + acc               (x = w)
//   smooth     out = 0.5 * x + (0.5 * acc) / d             (d = the clamped degree)
//
// The order. Each term is one __fmul_rn; each row's terms are added one
// after another, in ascending edge id, starting from +0.0, with __fadd_rn
// (no FMA contraction, no split or re-associated chain, no float atomics).
// That is the order of the plain version on the CPU, index_add_ of
// scale[:, None] * x[col] into zeros (and of XLA's scatter-add on the CPU),
// and the epilogues are the plain version's elementwise operations, so the
// card's result equals it bit for bit and two launches give the same bits.
//
// What bounds it. Bytes: col and scale are read once, x's rows once each
// (a row is fetched by every edge that reaches it, mostly from L2), the
// offsets once and out written once, plus the epilogue's operands ([n, F]
// l, out2, [n] d, parts, live); one multiply and one add for every 8 bytes
// of edge data. On Twitter the 47,691-edge hub bounds it instead: its row
// is 47,691 dependent adds a column, which no design may split, so it takes
// at least that many times the add's latency (~0.098 ms at 1.98 GHz),
// several times the whole product's bytes bound.
//
// Design: one launch, roles by block.
//
// * The first blocks take the rows of more than `long_at` edges, longest
//   first (long_ids comes sorted so), one block for every 16 columns of one,
//   so the longest chains start at the kernel's first cycle and the short
//   rows run beside them. Warps 4-7 produce: they copy the rows x[col[e]]
//   and the scales into a ring of kStages stages in shared memory with
//   cp.async, each stage's col entries loaded three stages ahead, and hand
//   a stage over by an mbarrier that the copies themselves complete. A
//   stage keeps each column's rows together and the scales as one more
//   column. Warps 1-3 multiply a landed stage in place (each term one
//   __fmul_rn) and hand it on by a second mbarrier, so that warp 0, one
//   lane a column, only reads products, 4 rows with one 16-byte load, and
//   adds them: a lane reads the next kAhead products while it adds the
//   previous kAhead, so the chain waits on the add's latency alone. At
//   F = 4 a stage is 256 rows.
// * At F = 4 (DiDiC's k; x, l, out and out2 16-byte aligned) the other
//   blocks take tiles: runs of consecutive
//   short rows, planned once with the matrix (csr_matrix), at most 256 rows
//   and kTileEdges edges (32 KB of x rows at F = 4) a tile (the CSR-stream
//   scheme of CSR-Adaptive, Greathouse and Daga). A tile's block loads its
//   col entries and scales one edge a thread, coalesced (the scales by
//   cp.async into shared memory), puts every edge's x row in flight at
//   once with cp.async into shared memory, multiplies each landed row by its
//   scale in place (the thread that copied it), and
//   then a thread a row adds its row's products in edge order, its 4 column
//   chains interleaved, applies the epilogue (its operands loaded at the
//   block's start) and writes the row; consecutive threads write
//   consecutive rows.
// * At any other width the other blocks take the short rows a group of P
//   lanes a row.
//   A lane owns a float4 of the row where F % 4 == 0 (else up to 4 columns,
//   P apart), loads the col entries and scales of kBatch edges together
//   (predicated: a row shorter than the batch issues all its loads at
//   once), then their x rows, then multiplies and adds them in edge order.
//
// Shared memory is dynamic: the long role's ring (26 KB) where the matrix
// has long rows, a tile's rows and scales (40 KB at F = 4) where the tiles
// run, the larger of the two. A matrix without long rows launches a kernel
// without the long role, held to 48 registers, so that five tile blocks fit
// on an SM (the long role's kernel takes 64-80). Measured on an H100
// (spmm_variants.py): DiDiC's GIS product takes 7-14 % and filesystem's
// 19-22 % less device time than at the compiler's own 70-72 registers
// (three blocks); six blocks at 40 registers take 0-6 % more than five.

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;                                // a block, any role
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 8;                                    // edges a lane-group lane loads before it adds them
constexpr int kSliceCols = 16;                               // long role: columns a block, one lane each
constexpr int kProducers = 128;                              // long role: threads 128-255 copy
constexpr int kMultiplyWarps = 3;                            // long role: warps 1-3 multiply
constexpr int kStages = 5;                                   // the ring's stages
constexpr int kStageFloats = 1312;                           // 5.1 KB a stage: (columns + scales) x (rows + 4)
constexpr int kRowsMax = 256;                                // rows a stage at most: two a producer
constexpr int kAhead = 8;                                    // products a consumer lane holds ahead of its chain
constexpr int kAheadStages = 3;                              // stages a producer loads col entries ahead
constexpr int kTileEdges = 2048;                             // edges a tile at most (ops.TILE_EDGES at most);
                                                             // rows a tile at most: kThreads (ops.TILE_ROWS)
constexpr int kTileEdgesPerThread = kTileEdges / kThreads;   // edges a thread stages
constexpr int kShortMinBlocks = 5;                           // blocks an SM without long rows: 48 registers

enum : int { kNone = 0, kSecondary = 1, kPrimary = 2, kSmooth = 3 };

// What the writer of a row applies to it (module comment).
struct Epilogue {
  int code;
  float member;             // secondary: b where the row is live and c == parts[s]
  const float* l;           // [n, F]: secondary, primary
  const float* d;           // [n]: degc (secondary, primary) or the clamped degree (smooth)
  const int* parts;         // [n]: secondary
  const uint8_t* live;      // [n] or null (every row live): secondary
  float* out2;              // [n, F]: secondary's out / b
};

// A row's operands that do not depend on its column.
struct RowOperands {
  float d;
  int part;
  bool live;
};

__device__ __forceinline__ RowOperands row_operands(const Epilogue& ep, int64_t s) {
  RowOperands r{0.0f, -1, false};
  if (ep.code != kNone) r.d = __ldg(ep.d + s);
  if (ep.code == kSecondary) {
    r.part = __ldg(ep.parts + s);
    r.live = ep.live == nullptr || __ldg(ep.live + s) != 0;
  }
  return r;
}

// The value of column c of the finished row: acc the product, xs the
// product's input at (s, c), ls l at (s, c); writes out2's value to *o2.
__device__ __forceinline__ float apply(const Epilogue& ep, const RowOperands& r, int64_t c, float acc, float xs,
                                       float ls, float* o2) {
  switch (ep.code) {
    case kSecondary: {
      const float v = __fadd_rn(__fsub_rn(ls, __fmul_rn(r.d, xs)), acc);
      *o2 = __fdiv_rn(v, r.live && r.part == c ? ep.member : 1.0f);
      return v;
    }
    case kPrimary: return __fadd_rn(__fsub_rn(__fadd_rn(xs, ls), __fmul_rn(r.d, xs)), acc);
    case kSmooth: return __fadd_rn(__fmul_rn(0.5f, xs), __fdiv_rn(__fmul_rn(0.5f, acc), r.d));
    default: return acc;
  }
}

// Writes column c of row s, its epilogue applied (reads its operands here).
__device__ __forceinline__ void write_one(const Epilogue& ep, const RowOperands& r, const float* __restrict__ x,
                                          float* __restrict__ out, int64_t s, int64_t F, int64_t c, float acc) {
  const int64_t i = s * F + c;
  const float xs = ep.code == kNone ? 0.0f : __ldg(x + i);
  const float ls = (ep.code == kSecondary || ep.code == kPrimary) ? __ldg(ep.l + i) : 0.0f;
  float o2 = 0.0f;
  out[i] = apply(ep, r, c, acc, xs, ls, &o2);
  if (ep.code == kSecondary) ep.out2[i] = o2;
}

__device__ __forceinline__ void copy4_async(uint32_t dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void copy16_async(uint32_t dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void copies_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
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
// the tile role (F = 4)
// ---------------------------------------------------------------------------
// One tile: rows [row0, row_end) and their edges [e0, e_end) (tiles [t] =
// {row0, row_end, e0, e_end}); every row one float4 (x, l, out and out2
// 16-byte aligned). xs holds the tile's rows, then its scales.
template <typename Off>
__device__ __forceinline__ void tile_role(const float* __restrict__ x, const int* __restrict__ col,
                                          const float* __restrict__ scale, const Off* __restrict__ offsets,
                                          const int64_t* __restrict__ tiles, float* __restrict__ out,
                                          const Epilogue& ep, int tile_edges, int64_t t, float* xs) {
  const int tid = threadIdx.x;
  const longlong2 rows = __ldg(reinterpret_cast<const longlong2*>(tiles) + 2 * t);
  const longlong2 edges = __ldg(reinterpret_cast<const longlong2*>(tiles) + 2 * t + 1);
  const int64_t e0 = edges.x;
  const int n_edges = (int)(edges.y - edges.x);
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  // this thread's row: its bounds and its epilogue's operands, loaded now
  const int64_t s = rows.x + tid;
  const bool has_row = s < rows.y;
  int begin = 0, end = 0;
  float4 xs_row = zero, l_row = zero;
  RowOperands ro{0.0f, -1, false};
  if (has_row) {
    begin = (int)((int64_t)__ldg(offsets + s) - e0);
    end = (int)((int64_t)__ldg(offsets + s + 1) - e0);
    ro = row_operands(ep, s);
    if (ep.code != kNone) xs_row = __ldg(reinterpret_cast<const float4*>(x) + s);
    if (ep.code == kSecondary || ep.code == kPrimary) l_row = __ldg(reinterpret_cast<const float4*>(ep.l) + s);
  }
  // the tile's edges, a thread every kThreads: the scales coalesced into
  // shared memory behind the rows, the col entries coalesced into
  // registers, then every edge's x row in flight at once
  float4* rows4 = reinterpret_cast<float4*>(xs);
  const float* ws = xs + 4 * tile_edges;
  const uint32_t base = smem_u32(xs);
  const uint32_t wbase = smem_u32(ws);
  int c[kTileEdgesPerThread];
#pragma unroll
  for (int u = 0; u < kTileEdgesPerThread; ++u) {
    const int j = tid + u * kThreads;
    c[u] = j < n_edges ? __ldg(col + e0 + j) : 0;
    if (j < n_edges) copy4_async(wbase + 4u * (uint32_t)j, scale + e0 + j);
  }
#pragma unroll
  for (int u = 0; u < kTileEdgesPerThread; ++u) {
    const int j = tid + u * kThreads;
    if (j < n_edges) copy16_async(base + 16u * (uint32_t)j, x + 4 * (int64_t)c[u]);
  }
  copies_wait_all();
  // each term one __fmul_rn, made by the thread that copied the row
#pragma unroll
  for (int u = 0; u < kTileEdgesPerThread; ++u) {
    const int j = tid + u * kThreads;
    if (j < n_edges) {
      const float w = ws[j];
      const float4 v = rows4[j];
      rows4[j] = make_float4(__fmul_rn(w, v.x), __fmul_rn(w, v.y), __fmul_rn(w, v.z), __fmul_rn(w, v.w));
    }
  }
  __syncthreads();
  if (!has_row) return;
  // the row's four chains, in edge order from +0.0
  float4 acc = zero;
#pragma unroll 4
  for (int j = begin; j < end; ++j) {
    const float4 v = rows4[j];
    acc.x = __fadd_rn(acc.x, v.x);
    acc.y = __fadd_rn(acc.y, v.y);
    acc.z = __fadd_rn(acc.z, v.z);
    acc.w = __fadd_rn(acc.w, v.w);
  }
  float4 o, o2;
  o.x = apply(ep, ro, 0, acc.x, xs_row.x, l_row.x, &o2.x);
  o.y = apply(ep, ro, 1, acc.y, xs_row.y, l_row.y, &o2.y);
  o.z = apply(ep, ro, 2, acc.z, xs_row.z, l_row.z, &o2.z);
  o.w = apply(ep, ro, 3, acc.w, xs_row.w, l_row.w, &o2.w);
  reinterpret_cast<float4*>(out)[s] = o;
  if (ep.code == kSecondary) reinterpret_cast<float4*>(ep.out2)[s] = o2;
}

// ---------------------------------------------------------------------------
// the lane-group role (every other row width)
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

template <typename Off>
__device__ __forceinline__ void lane_role(const float* __restrict__ x, const int* __restrict__ col,
                                          const float* __restrict__ scale, const Off* __restrict__ offsets,
                                          float* __restrict__ out, const Epilogue& ep, int64_t n, int64_t F, int P,
                                          bool vec, int64_t long_at, int64_t block) {
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
  const RowOperands ro = row_operands(ep, s);
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
      write_one(ep, ro, x, out, s, F, c, acc.x);
      write_one(ep, ro, x, out, s, F, c + 1, acc.y);
      write_one(ep, ro, x, out, s, F, c + 2, acc.z);
      write_one(ep, ro, x, out, s, F, c + 3, acc.w);
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
      if (c0 + k * P < F) write_one(ep, ro, x, out, s, F, c0 + k * P, acc[k]);
    }
  }
}

// ---------------------------------------------------------------------------
// the long role
// ---------------------------------------------------------------------------
// Rows a stage holds for a slice of cw columns: 256, 128 or 64. A stage
// keeps each column's rows together (R rows and 4 floats of padding), then
// the scales as column cw, so that a consumer lane reads 4 products of its
// column with one 16-byte load; a column is then R + 4 = 4 (mod 32) floats
// long, and the lanes' 16-byte reads fall on distinct banks.
__device__ __forceinline__ int stage_rows(int cw) {
  const int fit = kStageFloats / (cw + 1) - 4;
  int r = kRowsMax;
  while (r > 64 && r > fit) r /= 2;
  return r;
}

// Reads products [first, first + kAhead) of a stage's column `xs` into v;
// 4-row groups at or past `rows` read as 0 (a group that `rows` cuts reads
// the column's padding, which add_rows skips).
__device__ __forceinline__ void read_rows(const float* xs, int first, int rows, float4 (&v)[kAhead / 4]) {
  const float4* pv = reinterpret_cast<const float4*>(xs + first);
  if (first + kAhead <= rows) {
#pragma unroll
    for (int q = 0; q < kAhead / 4; ++q) v[q] = pv[q];
  } else {
#pragma unroll
    for (int q = 0; q < kAhead / 4; ++q) v[q] = first + 4 * q < rows ? pv[q] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
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
      const float ev[4] = {v[q].x, v[q].y, v[q].z, v[q].w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (first + 4 * q + k < rows) acc = __fadd_rn(acc, ev[k]);
      }
    }
  }
  return acc;
}

// Adds the R products of a full stage's column to `acc` in row order. Two
// register sets take turns: the next kAhead products are read while the
// current ones are added, so the reads hide behind the chain. Unrolled
// whole, so no loop test or branch sits in the chain.
template <int R>
__device__ __forceinline__ float add_full_stage(const float* xs, float acc) {
  float4 a[kAhead / 4], b[kAhead / 4];
  read_rows(xs, 0, R, a);
#pragma unroll
  for (int r = 0; r < R; r += 2 * kAhead) {
    read_rows(xs, r + kAhead, R, b);
    acc = add_rows(a, 0, kAhead, acc);
    if (r + 2 * kAhead < R) read_rows(xs, r + 2 * kAhead, R, a);
    acc = add_rows(b, 0, kAhead, acc);
  }
  return acc;
}

// Adds `rows` products of one stage's column to `acc` in row order: a full
// stage unrolled, a row's last stage in the same two turns with its bounds
// tested. Every branch is the same for the whole warp.
__device__ __forceinline__ float add_stage(const float* xs, int rows, int R, float acc) {
  if (rows == R) {
    switch (R) {
      case 256: return add_full_stage<256>(xs, acc);
      case 128: return add_full_stage<128>(xs, acc);
      default: return add_full_stage<64>(xs, acc);
    }
  }
  float4 a[kAhead / 4], b[kAhead / 4];
  read_rows(xs, 0, rows, a);
  for (int r = 0; r < rows; r += 2 * kAhead) {
    read_rows(xs, r + kAhead, rows, b);
    acc = add_rows(a, r, rows, acc);
    read_rows(xs, r + 2 * kAhead, rows, a);
    acc = add_rows(b, r + kAhead, rows, acc);
  }
  return acc;
}

// One long block: the columns [c0, c0 + cw) of one long row, cw at most
// kSliceCols. Warp 0 adds, one lane a column; warps 1-3 multiply; warps
// 4-7 copy.
template <typename Off>
__device__ __forceinline__ void long_role(const float* __restrict__ x, const int* __restrict__ col,
                                          const float* __restrict__ scale, const Off* __restrict__ offsets,
                                          const int64_t* __restrict__ long_ids, float* __restrict__ out,
                                          const Epilogue& ep, int64_t F, int64_t block, int slices, float* ring,
                                          uint64_t* bars) {
  const int64_t s = __ldg(long_ids + block / slices);
  const int64_t c0 = (block % slices) * (int64_t)kSliceCols;
  const int cw = (int)(F - c0 < kSliceCols ? F - c0 : kSliceCols);
  const int64_t begin = __ldg(offsets + s);
  const int64_t len = (int64_t)__ldg(offsets + s + 1) - begin;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const uint32_t full0 = smem_u32(bars);                  // full[k]: the stage's copies landed
  const uint32_t ready0 = smem_u32(bars + kStages);       // ready[k]: the stage's terms were multiplied
  const uint32_t empty0 = smem_u32(bars + 2 * kStages);   // empty[k]: the stage's terms were added
  if (tid == 0) {
    for (int k = 0; k < kStages; ++k) {
      mbar_init(full0 + 8 * k, kProducers);
      mbar_init(ready0 + 8 * k, kMultiplyWarps);
      mbar_init(empty0 + 8 * k, 1);
    }
  }
  __syncthreads();
  const int R = stage_rows(cw);   // rows a stage
  const int S = R + 4;            // floats a column of a stage
  const int64_t stages = (len + R - 1) / R;
  if (warp == 0) {
    // the consumer: one column a lane, the row's products in edge order
    // (lanes past cw add a copy of the last column, so the warp never splits)
    const int c = tid < cw ? tid : cw - 1;
    float acc = 0.0f;
    for (int64_t i = 0; i < stages; ++i) {
      const uint32_t slot = i % kStages;
      mbar_wait(ready0 + 8 * slot, (i / kStages) & 1);
      const int rows = (int)(len - i * R < R ? len - i * R : R);
      acc = add_stage(ring + slot * kStageFloats + c * S, rows, R, acc);
      __syncwarp();
      if (tid == 0) mbar_arrive(empty0 + 8 * slot);
    }
    if (tid < cw) write_one(ep, row_operands(ep, s), x, out, s, F, c0 + tid, acc);
    return;
  }
  if (warp <= kMultiplyWarps) {
    // a multiplier: the landed stage's terms, scale times row, in place
    const int m = tid - 32;
    for (int64_t i = 0; i < stages; ++i) {
      const uint32_t slot = i % kStages;
      mbar_wait(full0 + 8 * slot, (i / kStages) & 1);
      const int rows = (int)(len - i * R < R ? len - i * R : R);
      float* st = ring + slot * kStageFloats;
      for (int r = m; r < rows; r += 32 * kMultiplyWarps) {
        const float w = st[cw * S + r];
        for (int cc = 0; cc < cw; ++cc) st[cc * S + r] = __fmul_rn(w, st[cc * S + r]);
      }
      __syncwarp();
      if ((tid & 31) == 0) mbar_arrive(ready0 + 8 * slot);
    }
    return;
  }
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

struct Args {
  const float* x;
  const int* col;
  const float* scale;
  const void* offsets;
  const int64_t* long_ids;
  const int64_t* tiles;
  float* out;
  int64_t n, F, n_long, long_at;
  int slices, P, vec, tile_edges;
  Epilogue ep;
};

// TILES: the short rows run as tiles (F = 4, aligned), else as lane
// groups. LONG: the matrix has long rows; without them the kernel leaves
// the long role out, and with it its registers, so that more short blocks
// fit on an SM.
template <typename Off, bool TILES, bool LONG>
__global__ void __launch_bounds__(kThreads, LONG ? 1 : kShortMinBlocks) segment_spmm_kernel(const Args a) {
  extern __shared__ __align__(128) float smem[];
  __shared__ __align__(8) uint64_t bars[3 * kStages];
  const Off* offsets = static_cast<const Off*>(a.offsets);
  const int64_t block = blockIdx.x;
  if constexpr (LONG) {
    if (block < a.n_long * a.slices) {
      long_role(a.x, a.col, a.scale, offsets, a.long_ids, a.out, a.ep, a.F, block, a.slices, smem, bars);
      return;
    }
  }
  if constexpr (TILES) {
    tile_role(a.x, a.col, a.scale, offsets, a.tiles, a.out, a.ep, a.tile_edges, block - a.n_long * a.slices, smem);
  } else {
    lane_role(a.x, a.col, a.scale, offsets, a.out, a.ep, a.n, a.F, a.P, a.vec != 0, a.long_at,
              block - a.n_long * a.slices);
  }
}

template <typename Off, bool TILES>
cudaError_t launch(const Args& a, long long blocks, size_t smem, cudaStream_t stream) {
  if (a.n_long > 0) {
    segment_spmm_kernel<Off, TILES, true><<<(unsigned)blocks, kThreads, smem, stream>>>(a);
  } else {
    segment_spmm_kernel<Off, TILES, false><<<(unsigned)blocks, kThreads, smem, stream>>>(a);
  }
  return cudaGetLastError();
}

template <typename Off>
cudaError_t launch_role(const Args& a, bool tiled, long long blocks, size_t smem, cudaStream_t stream) {
  return tiled ? launch<Off, true>(a, blocks, smem, stream) : launch<Off, false>(a, blocks, smem, stream);
}

bool aligned16(const void* p) { return p == nullptr || (uintptr_t)p % 16 == 0; }

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch. offsets are int32 where
// off32 is set, else int64; long_ids [n_long] are the rows of more than
// long_at edges, longest first; tiles [n_tiles, 4] int64 the short rows'
// tiles (read at F = 4, aligned), each of at most tile_edges edges. epi: 0 none,
// 1 secondary, 2 primary, 3 smooth; l, d, parts, live and out2 as the
// epilogue reads them (null where it does not).
int segment_spmm_launch(const void* x, const void* col, const void* scale, const void* offsets, int off32,
                        const void* long_ids, long long n_long, long long long_at, const void* tiles,
                        long long n_tiles, long long tile_edges, void* out, long long n, long long F, int epi,
                        float member, const void* l, const void* d, const void* parts, const void* live, void* out2,
                        void* stream) {
  if (n == 0 || F == 0) return (int)cudaGetLastError();
  if (tile_edges > kTileEdges) return (int)cudaErrorInvalidValue;
  Args a{};
  a.x = (const float*)x;
  a.col = (const int*)col;
  a.scale = (const float*)scale;
  a.offsets = offsets;
  a.long_ids = (const int64_t*)long_ids;
  a.tiles = (const int64_t*)tiles;
  a.out = (float*)out;
  a.n = n;
  a.F = F;
  a.n_long = n_long;
  a.long_at = long_at;
  a.ep = Epilogue{epi, member, (const float*)l, (const float*)d, (const int*)parts, (const uint8_t*)live,
                  (float*)out2};
  a.slices = (int)((F + kSliceCols - 1) / kSliceCols);  // long blocks a long row
  a.vec = F % 4 == 0 && aligned16(x) && aligned16(out) && aligned16(l) && aligned16(out2);
  const bool tiled = F == 4 && a.vec;
  long long blocks = n_long * a.slices;
  size_t smem = n_long > 0 ? (size_t)kStages * kStageFloats * sizeof(float) : 0;
  if (tiled) {
    blocks += n_tiles;
    a.tile_edges = (int)tile_edges;
    const size_t tile_bytes = (size_t)tile_edges * 5 * sizeof(float);  // the rows and the scales
    if (tile_bytes > smem) smem = tile_bytes;
  } else {
    const long long slots = a.vec ? F / 4 : F;  // a row's float4s, or its floats
    int P = 1;
    while (P < slots && P < 32) P *= 2;
    a.P = P;
    const long long per_block = (long long)kWarps * (32 / P);
    blocks += (n + per_block - 1) / per_block;
  }
  if (blocks == 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(off32 ? launch_role<int32_t>(a, tiled, blocks, smem, s) : launch_role<int64_t>(a, tiled, blocks, smem, s));
}

const char* segment_spmm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
