// flash_attention_bwd: the backward of flash_attention (csrc/flash_attention.cu)
// for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package has no Pallas backward and
// differentiates its oracle, so this computes what jax.grad of
// attention_ref (src/repro/kernels/flash_attention/ref.py) computes:
//
//   P  = exp(S * scale - lse),  S = Q K^T, masked entries P = 0,
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - Delta),  Delta = rowsum(dO o O),
//   dQ = dS K * scale,  dK = dS^T Q * scale,
//
// with q/o/dO [B*Hq, Tq, Dh], k/v [B*Hkv, Tk, Dh] batch-head major (q head
// bh reads kv head bh / G, G = Hq/Hkv) and lse [B*Hq, Tq] float32 from the
// forward (natural log). A kv head's dK and dV are the sums over its G q
// heads. Masked: keys past Tk, rows past Tq and (causal) keys past the query
// position i + q_offset; they are loaded as zeros and their P is forced to
// exactly 0, never exp(0 - garbage).
//
// What bounds it: operations. The four products the gradient needs are 8 *
// Hq * pairs * Dh operations on ~4 * (Hq + Hkv) * Tk * Dh * 2 bytes; at
// granite-3-8b's prefill shape (Hq 32, Hkv 8, T 4096, Dh 128, causal) that
// is 274.9 GFLOP on 84 MB, far above the tensor cores' ~295 operations a byte.
//
// Route 1, "wgmma" (bfloat16; FlashAttention-3's backward shape): one sweep
// computes dK, dV and dQ, 10 * Hq * pairs * Dh operations (S and dP once).
// One call is three kernels on the caller's stream:
//   a. Delta = rowsum(dO o O) in float32 (scratch from the wrapper, rows of
//      a stride that is a multiple of 4 values: TMA reads them);
//   b. the sweep (bwd_wgmma_kernel): a work item is one (kv head, 128-key
//      tile); a step is one (q head of the group, 64-row query tile) that
//      the mask lets see the tile. A 384-thread block takes one item.
//      Warpgroup 0 is the producer (setmaxnreg.dec): one thread loads K and
//      V once by TMA, then each step's Q and dO tiles (128-byte swizzle) and
//      its 64 lse and Delta values into a 2-stage ring with full and empty
//      mbarriers; rows past Tq or Tk arrive as zeros through the tensor
//      maps' out-of-bounds fill. Warpgroups 1 and 2 are the consumers
//      (setmaxnreg.inc), 64 keys each. A step, the thread holding two query
//      rows of each 64 x 64 tile (so two lse and two Delta values):
//        S  = Q K^T            wgmma SS m64n64k16, both tiles K-major;
//        dP = dO V^T           the same, issued with S;
//        P  = 2^(S scale log2 e - lse log2 e), masked entries exactly 0,
//             stored as bf16 into the consumer's [64 x 64] P box;
//        dS = P o (dP - Delta), stored as bf16 into its half of the step's
//             [64 queries x 128 keys] dS tile (two tiles, by step parity);
//        (named barrier: both consumers' dS are in shared memory)
//        dV += P^T dO          SS m64nDHk16, P read MN-major (the transpose
//                              bit gives P^T), dO MN-major;
//        dK += dS^T Q          the same from the dS half and Q;
//        dQ_t = dS K           SS m64n64k16 over the 128 keys, dS K-major, K
//                              MN-major: consumer w the columns 64w.. (at
//                              Dh 64 consumer 0 alone).
//      dK and dV stay in float32 registers for the whole item and are
//      written once (dK scaled), so the group sum needs no atomics.
//      Registers bound the consumers (dK and dV hold 128 a thread): P and
//      dS go through shared memory, the first k-step of each product only
//      writes its accumulator, and masks, descriptors and addresses are
//      rebuilt each step rather than kept live across the loop.
//   c. dq = bf16(dq_acc * scale), dq_acc the float32 sum of the steps' dQ_t.
// The dQ sum is ordered. The consumers stage dQ_t (float32, in their
// fragment order) in shared memory; a second producer thread adds it into
// dq_acc ([B*Hq, ceil(Tq/64), 64 * Dh], the same fragment order, zeroed by
// the wrapper) with one cp.reduce.async.bulk .add.f32 once the tile's
// semaphore (an int per (q head, 64-row query tile)) reads the item's key
// tile kt, waits for the add to complete, and stores kt + 1. A query
// tile is seen by key tiles 0..K and no others (causal masking is monotone
// in the key for any q_offset; without the mask every tile sees every key
// tile), so key tile kt's add follows exactly the adds of tiles 0..kt-1:
// every element of dq_acc is summed in key-tile order on every call, and
// two calls give the same bits. Steps run query tile by query tile from the
// last down, the group's q heads inside, so the items of one kv head take
// their common steps in the same order and each add waits for one add only.
// Integer atomics touch only the semaphores and a ticket: a block takes its
// item by atomicAdd on the ticket, in grid order (key tile major, key tile
// 0 first), never by blockIdx. So the items a block waits for (the same kv
// head's lower key tiles) hold smaller tickets: they were taken by blocks
// already running, which never wait on a larger ticket, and by induction on
// the ticket every wait ends, whatever order the hardware dispatches blocks
// in. No float sum depends on scheduling. P = 2^(...) by ex2.approx; P and
// dS are rounded to bf16 as operands, as the forward rounds P. Head dims 64
// and 128; the wrapper zero-pads others.
//
// Route 0, "ffma" (float32): FlashAttention-2's two passes on the float32
// pipe (the JAX tests' float32 bars rule out TF32): a. Delta; b. one block
// per (kv head, 64-key tile) accumulating dK and dV over the group's q
// heads and visible query tiles; c. one block per (q head, 64-query tile)
// accumulating dQ over the visible key tiles (S and dP computed twice, every
// sum in a fixed order). The forward's ffma layout: 256 threads as 16 x 16,
// each a 4 x 4 block of a 64 x 64 score tile, rows of the staged tiles padded
// to Dh + 4 floats; P^T and dS^T (pass b) or dS (pass c) go through shared
// memory to the products that reduce over the tile. Any head dim 1..128
// (zero columns beyond it). expf, not __expf.

#include <math.h>
#include <stdint.h>

#include <atomic>
#include <initializer_list>

#include "hopper.cuh"

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// ---------------------------------------------------------------------------
// a. Delta = rowsum(dO o O): one warp a row.
// ---------------------------------------------------------------------------

// Row r of [B*Hq * Tq] is stored at delta[(r / Tq) * ld + r % Tq].
template <typename T>
__global__ void __launch_bounds__(256)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
             int64_t rows, int Dh, int64_t Tq, int64_t ld) {
  const int64_t row = (int64_t)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warps leave together
  const T* orow = o + row * Dh;
  const T* drow = dout + row * Dh;
  float s = 0.0f;
  for (int d = lane; d < Dh; d += 32) s = fmaf(to_f32(orow[d]), to_f32(drow[d]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[(row / Tq) * ld + row % Tq] = s;
}

template <typename T>
int delta_launch(const void* o, const void* dout, float* delta, long long rows, long long Dh, long long Tq,
                 long long ld, cudaStream_t stream) {
  if (rows == 0) return (int)cudaSuccess;
  const long long blocks = (rows + 7) / 8;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  delta_kernel<T><<<(unsigned)blocks, 256, 0, stream>>>((const T*)o, (const T*)dout, delta, rows, (int)Dh, Tq, ld);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Route 1: bfloat16 on the tensor cores (wgmma, TMA).
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;

constexpr int kKT = 128;               // keys a work item
constexpr int kQT = 64;                // queries a step
constexpr int kWThreads = 384;         // producer warpgroup + 2 consumers
constexpr int kKBox = 128 * 64 * 2;    // bytes of one [128 rows x 64 bf16] box (K, V)
constexpr int kQBox = kQT * 64 * 2;    // bytes of one [64 rows x 64 bf16] box (Q, dO, P, dS)
constexpr int kVecBytes = kQT * 4;     // a step's lse (or Delta) values
constexpr int kStages = 2;

__device__ __forceinline__ float lds_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// global[0 .. bytes) += shared[0 .. bytes), float32, by the TMA unit, as one
// bulk group. bulk_wait_read: shared memory has been read (the staging tile
// may be refilled); bulk_wait: the add has completed in global memory.
__device__ __forceinline__ void bulk_add_f32(float* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n" ::"l"(dst),
               "r"(src), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() { asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory"); }
__device__ __forceinline__ void bulk_wait() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

// A base descriptor moved on by `bytes` (a multiple of 16; the address
// field counts 16-byte units and shared addresses stay below its 14 bits).
__device__ __forceinline__ uint64_t desc_at(uint64_t base, uint32_t bytes) {
  return base + (bytes >> 4);
}

// A value the compiler must take as new on every step, so that nothing
// derived from it is kept live across the loop: registers are the
// consumers' scarce resource (dK and dV hold 128 a thread).
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// X[64 x 64] = A[64 rows of a, DH] B[64 rows of b, DH]^T: A a Q or dO tile
// (64-row boxes), B 64 rows of a K or V tile (128-row boxes), both K-major.
template <int DH>
__device__ __forceinline__ void issue_s(float (&acc)[32], uint32_t a, uint32_t b) {
  const uint64_t da = sw128_desc(a, 16), db = sw128_desc(b, 16);
  wgmma_ss_m64n64k16_first<0, 0>(acc, da, db);
#pragma unroll
  for (int kk = 1; kk < DH / 16; ++kk) {
    const uint32_t col = (kk & 3) * 32;
    wgmma_ss_m64n64k16<0, 0>(acc, desc_at(da, (kk >> 2) * kQBox + col), desc_at(db, (kk >> 2) * kKBox + col), 1);
  }
}

// acc[64 keys x DH] += X^T B: X a [64 queries x 64 keys] bf16 box (P or dS)
// read MN-major as the A operand X^T, B a Q or dO tile [64 queries x DH]
// read MN-major; a k-step is 16 queries (16 rows of 128 bytes), the stride
// byte offset (1024) steps 8 rows, the leading byte offset the second
// 64-column box of B at DH = 128.
template <int DH>
__device__ __forceinline__ void issue_tn(float (&acc)[DH / 2], uint32_t x, uint32_t b) {
  const uint64_t da = sw128_desc(x, kQBox), db = sw128_desc(b, kQBox);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (DH == 128) {
      wgmma_ss_m64n128k16<1, 1>(acc, desc_at(da, kk * 16 * 128), desc_at(db, kk * 16 * 128), 1);
    } else {
      wgmma_ss_m64n64k16<1, 1>(acc, desc_at(da, kk * 16 * 128), desc_at(db, kk * 16 * 128), 1);
    }
  }
}

// dQ_t[64 queries x 64 columns] = dS[64 x 128 keys] K[128 keys x 64 columns]:
// dS K-major from its two [64 x 64] boxes, K MN-major from one box of the K
// tile; a k-step is 16 keys.
__device__ __forceinline__ void issue_dq(float (&acc)[32], uint32_t ds, uint32_t kbox) {
  const uint64_t da = sw128_desc(ds, 16), db = sw128_desc(kbox, kKBox);
  wgmma_ss_m64n64k16_first<0, 1>(acc, da, db);
#pragma unroll
  for (int kk = 1; kk < kKT / 16; ++kk)
    wgmma_ss_m64n64k16<0, 1>(acc, desc_at(da, (kk >> 2) * kQBox + (kk & 3) * 32), desc_at(db, kk * 16 * 128), 1);
}

// Rows r0 and r0 + 8 of an m64n64 float32 tile (register 4i + e: row r0 +
// 8 (e >> 1), column 8i + 2 (lane & 3) + (e & 1)) as bf16 into a [64 x 64]
// box with the 128-byte swizzle: 16-byte chunk i of row r sits at chunk
// i ^ (r & 7); row r0 + 8 is 1024 bytes on, with the same swizzle. The row
// base and swizzle pass through opaque(), so that the compiler keeps none
// of the 16 addresses live from one step to the next.
__device__ __forceinline__ void store_box(uint32_t box, const float (&x)[32], int r0, int lane) {
  const uint32_t base = opaque(box + r0 * 128 + 4 * (lane & 3));
  const uint32_t sw = opaque(r0 & 7);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(base + h * 1024 + ((i ^ sw) << 4)),
                   "r"(pack_bf16(x[4 * i + 2 * h], x[4 * i + 2 * h + 1]))
                   : "memory");
}

// b. The sweep. Register 4i + e of a consumer thread's m64n64 S, P, dP
// and dS is query (row) q0 + r0 + 8 (e >> 1), key (column) kw0 + 8i + 2
// (lane & 3) + (e & 1); of its m64nDH dK and dV, key key0 + 8 (e >> 1),
// column 8i + 2 (lane & 3) + (e & 1). `order` holds the ticket (order[0])
// and the semaphores (order[1 + bh * n_qt + qt]); dq_acc [B*Hq][n_qt][64 *
// DH] float32, consumer w's dQ_t the 16 KB from w * 16 KB of a tile.
template <int DH>
__global__ void __launch_bounds__(kWThreads, 1)
bwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                 const __grid_constant__ CUtensorMap tm_lse, const __grid_constant__ CUtensorMap tm_delta,
                 bf16* __restrict__ dk, bf16* __restrict__ dv, float* __restrict__ dq_acc, int* __restrict__ order,
                 int BHkv, int Tq, int Tk, int group, int causal, int q_offset, float scale, int n_qt) {
  constexpr int NB = DH / 64;         // 64-column boxes a row
  constexpr int QST = NB * kQBox;     // bytes of a Q (or dO) stage
  constexpr int DQW = DH / 64;        // consumers computing dQ columns
  constexpr int DQ_BYTES = 64 * DH * 4;  // a step's dQ_t, float32
  extern __shared__ uint8_t bwd_smem[];
  __shared__ int item_s;
  const uint32_t raw = smem_u32(bwd_smem);
  const uint32_t sk = (raw + 1023u) & ~1023u;   // K: NB boxes
  const uint32_t sv = sk + NB * kKBox;           // V: NB boxes
  const uint32_t sq = sv + NB * kKBox;           // Q: [kStages] stages
  const uint32_t so = sq + kStages * QST;        // dO: [kStages] stages
  const uint32_t spb = so + kStages * QST;       // P: [64 queries x 64 keys] a consumer
  const uint32_t sds = spb + 2 * kQBox;          // dS: [2 steps][64 queries x 64 keys] a consumer
  const uint32_t sdq = sds + 4 * kQBox;          // dQ_t, float32, fragment order
  const uint32_t sl = sdq + DQ_BYTES;            // lse: [kStages][64]
  const uint32_t sdl = sl + kStages * kVecBytes; // Delta: [kStages][64]
  const uint32_t bars = sdl + kStages * kVecBytes;
  const uint32_t bar_kv = bars;
  auto bar_full = [&](int s) { return bars + 8u * (1 + s); };
  auto bar_empty = [&](int s) { return bars + 8u * (1 + kStages + s); };
  const uint32_t bar_dq_full = bars + 8u * (1 + 2 * kStages);
  const uint32_t bar_dq_empty = bar_dq_full + 8u;

  if (threadIdx.x == 0) {
    item_s = atomicAdd(order, 1);
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full(s), 1);
      mbar_init(bar_empty(s), 8);  // one arrival per consumer warp
    }
    mbar_init(bar_dq_full, 128 * DQW);  // every thread of the dQ consumers
    mbar_init(bar_dq_empty, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  const int item = item_s;
  const int kvh = item % BHkv;
  const int kt = item / BHkv;
  const int k0 = kt * kKT;
  const int first_qt = causal && k0 > q_offset ? (k0 - q_offset) / kQT : 0;
  const int n_vis = n_qt > first_qt ? n_qt - first_qt : 0;
  const int n_it = group * n_vis;
  // Step it: query tile n_qt - 1 - it / group (from the last down), q head
  // kvh * group + it % group. Every item of a kv head takes its (q head,
  // query tile)s in the same order, the lower key tiles' lists running on
  // past the higher ones' ends, so an item's add of step it waits only for
  // its predecessor's add of the same step.
  auto step_qt = [&](int it) { return n_qt - 1 - it / group; };
  auto step_bh = [&](int it) { return kvh * group + it % group; };

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0 && n_it > 0) {
      // ---- loader ----
      mbar_expect_tx(bar_kv, 2 * NB * kKBox);
      for (int c = 0; c < NB; ++c) tma_load_3d(sk + c * kKBox, &tm_k, bar_kv, c * 64, k0, kvh);
      for (int c = 0; c < NB; ++c) tma_load_3d(sv + c * kKBox, &tm_v, bar_kv, c * 64, k0, kvh);
      for (int it = 0; it < n_it; ++it) {
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(bar_empty(s), ((it / kStages) - 1) & 1);
        const int bh = step_bh(it);
        const int q0 = step_qt(it) * kQT;
        mbar_expect_tx(bar_full(s), 2 * QST + 2 * kVecBytes);
        for (int c = 0; c < NB; ++c) tma_load_3d(sq + s * QST + c * kQBox, &tm_q, bar_full(s), c * 64, q0, bh);
        for (int c = 0; c < NB; ++c) tma_load_3d(so + s * QST + c * kQBox, &tm_do, bar_full(s), c * 64, q0, bh);
        tma_load_2d(sl + s * kVecBytes, &tm_lse, bar_full(s), q0, bh);
        tma_load_2d(sdl + s * kVecBytes, &tm_delta, bar_full(s), q0, bh);
      }
    } else if (threadIdx.x == 32 && n_it > 0) {
      // ---- dQ adder: dq_acc tile += dQ_t, in key-tile order ----
      for (int it = 0; it < n_it; ++it) {
        const int bh = step_bh(it);
        const int qt = step_qt(it);
        int* sem = order + 1 + (size_t)bh * n_qt + qt;
        // The tile's turn first, while the consumers still compute dQ_t. A
        // wait that outlasts seconds is a fault (an item waiting on one that
        // cannot start): trap, so that the call fails instead of hanging.
        for (long long spins = 0; ld_acquire(sem) != kt; ++spins) {
          if (spins > (1LL << 27)) __trap();
          __nanosleep(32);
        }
        asm volatile("fence.proxy.async.global;\n" ::: "memory");
        mbar_wait(bar_dq_full, it & 1);
        bulk_add_f32(dq_acc + ((size_t)bh * n_qt + qt) * (64 * DH), sdq, DQ_BYTES);
        bulk_wait_read();
        mbar_arrive(bar_dq_empty);
        bulk_wait();
        asm volatile("fence.proxy.async.global;\n" ::: "memory");
        __threadfence();
        st_release(sem, kt + 1);
      }
    }
  } else {
    // ---- consumers: 64 keys each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = wg - 1;
    const int tid = threadIdx.x & 127;
    const int lane = tid & 31;
    const int kw0 = k0 + cw * 64;                  // the warpgroup's first key
    const int r0 = (tid >> 5) * 16 + (lane >> 2);  // the thread's rows of a 64-row tile: r0, r0 + 8
    const int key0 = kw0 + r0;
    const float scale_log2 = scale * kLog2e;

    float dka[DH / 2], dva[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) dka[i] = dva[i] = 0.0f;

    if (n_it > 0) {
      float sp[32], dp[32], dqa[32];  // S then P; dP then dS; dQ_t
      const uint32_t ka = sk + cw * 64 * 128, va = sv + cw * 64 * 128;  // the warpgroup's 64 rows of K and V
      const uint32_t pbox = spb + cw * kQBox;
      mbar_wait(bar_kv, 0);
      for (int it = 0; it < n_it; ++it) {
        const int s = it % kStages;
        const int q0 = step_qt(it) * kQT;
        const uint32_t qs = opaque(sq + s * QST), os = opaque(so + s * QST);
        const uint32_t ls = sl + s * kVecBytes, ds = sdl + s * kVecBytes;  // this step's lse and Delta
        const uint32_t dsb = sds + (it & 1) * 2 * kQBox;                   // this step's dS tile (both boxes)

        mbar_wait(bar_full(s), (it / kStages) & 1);
        wg_fence();
        issue_s<DH>(sp, qs, opaque(ka));  // S = Q K^T
        wg_commit();
        issue_s<DH>(dp, os, opaque(va));  // dP = dO V^T
        wg_commit();
        // Row h of the thread sees key kb + j (j = 8i + (e & 1)) iff j <= lim[h]:
        // keys up to Tk - 1 and (causal) the row's position + q_offset; no
        // key for a row past Tq. Two ints a step and no unmasked fast path:
        // registers, not the compares, bound the consumers.
        const int kb = opaque(kw0 + 2 * (lane & 3));
        float lse2[2], dl[2];
        int lim[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          lse2[h] = lds_f32(ls + 4 * (r0 + 8 * h)) * kLog2e;
          dl[h] = lds_f32(ds + 4 * (r0 + 8 * h));
          const int qpos = q0 + r0 + 8 * h;
          const int last = causal && qpos + q_offset < Tk - 1 ? qpos + q_offset : Tk - 1;
          lim[h] = qpos < Tq ? last - kb : -1;
        }
        wg_wait<1>();
        reg_fence(sp);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool ok = 8 * i + (e & 1) <= lim[e >> 1];
            sp[4 * i + e] = ok ? exp2_(fmaf(sp[4 * i + e], scale_log2, -lse2[e >> 1])) : 0.0f;
          }
        store_box(opaque(pbox), sp, r0, lane);
        wg_wait<0>();  // dP is done
        reg_fence(dp);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) dp[4 * i + e] = sp[4 * i + e] * (dp[4 * i + e] - dl[e >> 1]);
        store_box(dsb + cw * kQBox, dp, r0, lane);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        named_sync(1);  // P and both consumers' dS are in shared memory
        reg_fence(dva);
        reg_fence(dka);
        wg_fence();
        issue_tn<DH>(dva, pbox, os);              // dV += P^T dO
        issue_tn<DH>(dka, dsb + cw * kQBox, qs);  // dK += dS^T Q
        wg_commit();
        if (cw < DQW) {
          issue_dq(dqa, dsb, opaque(sk + cw * kKBox));  // dQ_t = dS K
          wg_commit();
        }
        wg_wait<0>();
        reg_fence(dva);
        reg_fence(dka);
        reg_fence(dqa);
        __syncwarp();
        if (lane == 0) mbar_arrive(bar_empty(s));  // Q, dO, lse and Delta of stage s are read
        if (cw < DQW) {
          if (it > 0) mbar_wait(bar_dq_empty, (it - 1) & 1);  // the adder has read the last dQ_t
          const uint32_t st = opaque(sdq + (cw * 8 * 128 + tid) * 16);
#pragma unroll
          for (int i = 0; i < 8; ++i)
            asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(st + i * 128 * 16), "f"(dqa[4 * i]),
                         "f"(dqa[4 * i + 1]), "f"(dqa[4 * i + 2]), "f"(dqa[4 * i + 3])
                         : "memory");
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          mbar_arrive(bar_dq_full);
        }
      }
    }

    bf16* dkb = dk + (size_t)kvh * Tk * DH;
    bf16* dvb = dv + (size_t)kvh * Tk * DH;
#pragma unroll
    for (int i = 0; i < DH / 8; ++i) {
      const int col = 8 * i + 2 * (lane & 3);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int key = key0 + 8 * h;
        if (key < Tk) {
          *reinterpret_cast<uint32_t*>(dkb + (size_t)key * DH + col) =
              pack_bf16(dka[4 * i + 2 * h] * scale, dka[4 * i + 2 * h + 1] * scale);
          *reinterpret_cast<uint32_t*>(dvb + (size_t)key * DH + col) = pack_bf16(dva[4 * i + 2 * h], dva[4 * i + 2 * h + 1]);
        }
      }
    }
  }
}

// c. dq = bf16(dq_acc * scale): one thread a float4 of dq_acc's fragment
// order (consumer w, chunk i, thread t), i.e. rows r, r + 8 and columns c,
// c + 1 of a [64 x DH] tile.
template <int DH>
__global__ void __launch_bounds__(256)
dq_convert_kernel(const float4* __restrict__ acc, bf16* __restrict__ dq, long long n4, int Tq, int n_qt, float scale) {
  const long long f = (long long)blockIdx.x * 256 + threadIdx.x;
  if (f >= n4) return;
  const long long tile = f / (16 * DH);
  const int rem = (int)(f % (16 * DH));
  const int w = rem >> 10, i = (rem >> 7) & 7, t = rem & 127;
  const int lane = t & 31;
  const int r = (t >> 5) * 16 + (lane >> 2);
  const int c = w * 64 + 8 * i + 2 * (lane & 3);
  const long long bh = tile / n_qt;
  const int row = (int)(tile % n_qt) * kQT + r;
  const float4 x = acc[f];
  bf16* dst = dq + (bh * Tq + row) * DH + c;
  if (row < Tq) *reinterpret_cast<uint32_t*>(dst) = pack_bf16(x.x * scale, x.y * scale);
  if (row + 8 < Tq) *reinterpret_cast<uint32_t*>(dst + 8 * DH) = pack_bf16(x.z * scale, x.w * scale);
}

template <int DH>
int wgmma_launch(const void* q, const void* k, const void* v, const void* o, const float* lse, const void* dout,
                 void* dq, void* dk, void* dv, float* delta, float* dq_acc, int* order, long long BHq, long long BHkv,
                 long long Tq, long long Tk, long long ld, int causal, long long q_offset, float scale,
                 cudaStream_t stream) {
  constexpr int NB = DH / 64;
  constexpr int smem = 1024 + 2 * NB * kKBox + 2 * kStages * NB * kQBox + 6 * kQBox + 64 * DH * 4 +
                       2 * kStages * kVecBytes + 8 * (3 + 2 * kStages);
  if (Tq == 0 || BHq == 0) {  // no query: dK and dV are zero
    cudaError_t e = cudaMemsetAsync(dk, 0, (size_t)BHkv * Tk * DH * 2, stream);
    if (e == cudaSuccess) e = cudaMemsetAsync(dv, 0, (size_t)BHkv * Tk * DH * 2, stream);
    return (int)e;
  }
  const long long n_kt = (Tk + kKT - 1) / kKT, n_qt = (Tq + kQT - 1) / kQT;
  if (Tq + q_offset + kQT > 0x7fffffffLL || Tk + kKT > 0x7fffffffLL || BHq > 0x7fffffffLL ||
      BHkv * n_kt > 0x7fffffffLL || BHq * n_qt >= 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  int err = delta_launch<bf16>(o, dout, delta, BHq * Tq, DH, Tq, ld, stream);
  if (err != cudaSuccess) return err;
  alignas(64) CUtensorMap mq, mk, mv, mdo, ml, md;
  if (!make_tensor_map(&mq, q, DH, Tq, BHq, kQT) || !make_tensor_map(&mdo, dout, DH, Tq, BHq, kQT) ||
      !make_tensor_map(&mk, k, DH, Tk, BHkv, kKT) || !make_tensor_map(&mv, v, DH, Tk, BHkv, kKT) ||
      !make_rows_map(&ml, lse, Tq, BHq, ld, kQT) || !make_rows_map(&md, delta, Tq, BHq, ld, kQT))
    return (int)cudaErrorInvalidValue;
  auto kernel = bwd_wgmma_kernel<DH>;
  // The shared-memory cap lasts for the process: raise it once a device.
  static std::atomic<bool> smem_set[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!smem_set[dev].load(std::memory_order_relaxed)) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_set[dev].store(true, std::memory_order_relaxed);
  }
  kernel<<<(unsigned)(BHkv * n_kt), kWThreads, smem, stream>>>(
      mq, mk, mv, mdo, ml, md, (bf16*)dk, (bf16*)dv, dq_acc, order, (int)BHkv, (int)Tq, (int)Tk,
      (int)(BHq / BHkv), causal, (int)q_offset, scale, (int)n_qt);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long n4 = BHq * n_qt * 16 * DH;
  dq_convert_kernel<DH><<<(unsigned)((n4 + 255) / 256), 256, 0, stream>>>(
      reinterpret_cast<const float4*>(dq_acc), (bf16*)dq, n4, (int)Tq, (int)n_qt, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Route 0: float32 on the float32 pipe.
// ---------------------------------------------------------------------------

constexpr int kFB = 64;        // rows of every staged tile
constexpr int kFThreads = 256;
constexpr int kFP = kFB + 4;   // row stride of the P and dS tiles

// Rows [r0, r0 + kFB) of a [n_rows, Dh] matrix into a [kFB][DH + 4] tile,
// zero past n_rows and past Dh.
template <int DH>
__device__ __forceinline__ void load_f32(float* dst, const float* __restrict__ src, int64_t r0, int64_t n_rows,
                                         int Dh) {
  constexpr int S = DH + 4;
  for (int e = threadIdx.x; e < kFB * DH; e += kFThreads) {
    const int r = e / DH, d = e % DH;
    dst[r * S + d] = r0 + r < n_rows && d < Dh ? src[(r0 + r) * Dh + d] : 0.0f;
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float x) {
  x = fmaf(a.x, b.x, x);
  x = fmaf(a.y, b.y, x);
  x = fmaf(a.z, b.z, x);
  return fmaf(a.w, b.w, x);
}

// s[r][c] = A[4r' rows] . B[16c' rows] and t[r][c] = C . E over DH columns:
// thread (tx, ty) takes rows ty*4 + r of A and C, rows tx + 16c of B and E.
template <int DH>
__device__ __forceinline__ void two_products(float (&s)[4][4], float (&t)[4][4], const float* A, const float* B,
                                             const float* C, const float* E, int tx, int ty) {
  constexpr int S = DH + 4;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[r][c] = t[r][c] = 0.0f;
#pragma unroll 2
  for (int d = 0; d < DH; d += 4) {
    float4 a[4], b[4], cc[4], e[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      a[r] = *reinterpret_cast<const float4*>(A + (ty * 4 + r) * S + d);
      cc[r] = *reinterpret_cast<const float4*>(C + (ty * 4 + r) * S + d);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      b[c] = *reinterpret_cast<const float4*>(B + (tx + 16 * c) * S + d);
      e[c] = *reinterpret_cast<const float4*>(E + (tx + 16 * c) * S + d);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = dot4(a[r], b[c], s[r][c]);
        t[r][c] = dot4(cc[r], e[c], t[r][c]);
      }
  }
}

// acc[r][c] += sum_j X[ty*4 + r][j] Y[j][col c], over the kFB rows j of Y; the
// thread's columns are the forward's: g*16W + tx*W + i.
template <int DH>
__device__ __forceinline__ void reduce_rows(float (&acc)[4][DH / 16], const float* X, const float* Y, int tx,
                                            int ty) {
  constexpr int S = DH + 4;
  constexpr int CPT = DH / 16;
  constexpr int W = CPT >= 4 ? 4 : CPT;
  constexpr int NG = CPT / W;
#pragma unroll 2
  for (int j = 0; j < kFB; j += 4) {
    float4 xr[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) xr[r] = *reinterpret_cast<const float4*>(X + (ty * 4 + r) * kFP + j);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      float yy[CPT];
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float* src = Y + (j + jj) * S + g * 16 * W + tx * W;
        if constexpr (W == 4) {
          const float4 t = *reinterpret_cast<const float4*>(src);
          yy[g * 4 + 0] = t.x; yy[g * 4 + 1] = t.y; yy[g * 4 + 2] = t.z; yy[g * 4 + 3] = t.w;
        } else {
          const float2 t = *reinterpret_cast<const float2*>(src);
          yy[g * 2 + 0] = t.x; yy[g * 2 + 1] = t.y;
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float x = jj == 0 ? xr[r].x : jj == 1 ? xr[r].y : jj == 2 ? xr[r].z : xr[r].w;
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[r][c] = fmaf(x, yy[c], acc[r][c]);
      }
    }
  }
}

template <int DH>
__device__ __forceinline__ void store_rows(float* dst, const float (&acc)[4][DH / 16], int64_t r0, int64_t n_rows,
                                           int Dh, float mul, int tx, int ty) {
  constexpr int CPT = DH / 16;
  constexpr int W = CPT >= 4 ? 4 : CPT;
  constexpr int NG = CPT / W;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int64_t row = r0 + ty * 4 + r;
    if (row >= n_rows) continue;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int i = 0; i < W; ++i) {
        const int col = g * 16 * W + tx * W + i;
        if (col < Dh) dst[row * Dh + col] = acc[r][g * W + i] * mul;
      }
  }
}

// b. dK/dV: block (kv head, 64-key tile); thread (tx, ty) scores keys
// ty*4 + r against queries tx + 16c and accumulates dK, dV rows ty*4 + r.
template <int DH>
__global__ void __launch_bounds__(kFThreads, 1)
dkdv_ffma_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                 const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dk, float* __restrict__ dv, int64_t BHkv, int64_t Tq, int64_t Tk, int Dh,
                 int group, int causal, int64_t q_offset, float scale) {
  constexpr int S = DH + 4;
  constexpr int CPT = DH / 16;
  extern __shared__ float4 ffma_smem[];
  float* Ks = reinterpret_cast<float*>(ffma_smem);  // [kFB][S]
  float* Vs = Ks + kFB * S;
  float* Qs = Vs + kFB * S;
  float* Os = Qs + kFB * S;       // dO
  float* Ps = Os + kFB * S;       // [kFB keys][kFP]: P^T
  float* Gs = Ps + kFB * kFP;     // [kFB keys][kFP]: dS^T
  float* Ls = Gs + kFB * kFP;     // [kFB]: lse
  float* Ds = Ls + kFB;           // [kFB]: Delta

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int64_t kvh = blockIdx.x % BHkv;
  const int64_t k0 = (int64_t)(blockIdx.x / BHkv) * kFB;
  const int64_t first_qt = causal && k0 > q_offset ? (k0 - q_offset) / kFB : 0;
  const int64_t n_qt = (Tq + kFB - 1) / kFB;
  load_f32<DH>(Ks, k + kvh * Tk * Dh, k0, Tk, Dh);
  load_f32<DH>(Vs, v + kvh * Tk * Dh, k0, Tk, Dh);

  float dka[4][CPT], dva[4][CPT];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) dka[r][c] = dva[r][c] = 0.0f;

  for (int g = 0; g < group; ++g) {
    const int64_t bh = kvh * group + g;
    for (int64_t qt = first_qt; qt < n_qt; ++qt) {
      const int64_t q0 = qt * kFB;
      __syncthreads();  // the last tile's products are done with Qs, Os, Ps, Gs
      load_f32<DH>(Qs, q + bh * Tq * Dh, q0, Tq, Dh);
      load_f32<DH>(Os, dout + bh * Tq * Dh, q0, Tq, Dh);
      if (threadIdx.x < kFB) {
        const bool ok = q0 + threadIdx.x < Tq;
        Ls[threadIdx.x] = ok ? lse[bh * Tq + q0 + threadIdx.x] : 0.0f;
        Ds[threadIdx.x] = ok ? delta[bh * Tq + q0 + threadIdx.x] : 0.0f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      two_products<DH>(s, dp, Ks, Qs, Vs, Os, tx, ty);  // S^T = K Q^T, dP^T = V dO^T
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int64_t key = k0 + ty * 4 + r;
          const int qi = tx + 16 * c;
          const bool ok = key < Tk && q0 + qi < Tq && (!causal || key <= q0 + qi + q_offset);
          const float p = ok ? expf(s[r][c] * scale - Ls[qi]) : 0.0f;
          Ps[(ty * 4 + r) * kFP + qi] = p;
          Gs[(ty * 4 + r) * kFP + qi] = p * (dp[r][c] - Ds[qi]);
        }
      __syncthreads();
      reduce_rows<DH>(dva, Ps, Os, tx, ty);  // dV += P^T dO
      reduce_rows<DH>(dka, Gs, Qs, tx, ty);  // dK += dS^T Q
    }
  }
  store_rows<DH>(dk + kvh * Tk * Dh, dka, k0, Tk, Dh, scale, tx, ty);
  store_rows<DH>(dv + kvh * Tk * Dh, dva, k0, Tk, Dh, 1.0f, tx, ty);
}

// c. dQ: block (q head, 64-query tile), most key tiles first; thread (tx,
// ty) scores queries ty*4 + r against keys tx + 16c.
template <int DH>
__global__ void __launch_bounds__(kFThreads, 1)
dq_ffma_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
               const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dq, int64_t BHq, int64_t Tq, int64_t Tk, int Dh, int group, int causal,
               int64_t q_offset, float scale, int n_q_tiles) {
  constexpr int S = DH + 4;
  constexpr int CPT = DH / 16;
  extern __shared__ float4 ffma_smem[];
  float* Qs = reinterpret_cast<float*>(ffma_smem);  // [kFB][S]
  float* Os = Qs + kFB * S;       // dO
  float* Ks = Os + kFB * S;
  float* Vs = Ks + kFB * S;
  float* Gs = Vs + kFB * S;       // [kFB queries][kFP]: dS

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int64_t bh = blockIdx.x % BHq;
  const int64_t q0 = (int64_t)(n_q_tiles - 1 - (int)(blockIdx.x / BHq)) * kFB;
  const int64_t kvh = bh / group;
  int64_t n_kv = (Tk + kFB - 1) / kFB;
  if (causal) {
    const int64_t last = (q0 + q_offset + kFB - 1) / kFB;
    n_kv = n_kv < last + 1 ? n_kv : last + 1;
  }
  load_f32<DH>(Qs, q + bh * Tq * Dh, q0, Tq, Dh);
  load_f32<DH>(Os, dout + bh * Tq * Dh, q0, Tq, Dh);
  float lr[4], dl[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int64_t row = q0 + ty * 4 + r;
    lr[r] = row < Tq ? lse[bh * Tq + row] : 0.0f;
    dl[r] = row < Tq ? delta[bh * Tq + row] : 0.0f;
  }
  float dqa[4][CPT];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) dqa[r][c] = 0.0f;

  for (int64_t kt = 0; kt < n_kv; ++kt) {
    const int64_t k0 = kt * kFB;
    __syncthreads();  // the last tile's dQ product is done with Ks and Gs
    load_f32<DH>(Ks, k + kvh * Tk * Dh, k0, Tk, Dh);
    load_f32<DH>(Vs, v + kvh * Tk * Dh, k0, Tk, Dh);
    __syncthreads();
    float s[4][4], dp[4][4];
    two_products<DH>(s, dp, Qs, Ks, Os, Vs, tx, ty);  // S = Q K^T, dP = dO V^T
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int64_t row = q0 + ty * 4 + r;
        const int64_t key = k0 + tx + 16 * c;
        const bool ok = key < Tk && row < Tq && (!causal || key <= row + q_offset);
        const float p = ok ? expf(s[r][c] * scale - lr[r]) : 0.0f;
        Gs[(ty * 4 + r) * kFP + tx + 16 * c] = p * (dp[r][c] - dl[r]);
      }
    __syncthreads();
    reduce_rows<DH>(dqa, Gs, Ks, tx, ty);  // dQ += dS K
  }
  store_rows<DH>(dq + bh * Tq * Dh, dqa, q0, Tq, Dh, scale, tx, ty);
}

template <int DH>
int ffma_launch(const void* q, const void* k, const void* v, const void* o, const float* lse, const void* dout,
                void* dq, void* dk, void* dv, float* delta, long long BHq, long long BHkv, long long Tq, long long Tk,
                int Dh, int causal, long long q_offset, float scale, cudaStream_t stream) {
  constexpr int S = DH + 4;
  constexpr int smem_kv = (4 * kFB * S + 2 * kFB * kFP + 2 * kFB) * (int)sizeof(float);
  constexpr int smem_q = (4 * kFB * S + kFB * kFP) * (int)sizeof(float);
  const long long n_kt = (Tk + kFB - 1) / kFB, n_qt = (Tq + kFB - 1) / kFB;
  if (BHkv * n_kt > 0x7fffffffLL || BHq * n_qt > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  int err = delta_launch<float>(o, dout, delta, BHq * Tq, Dh, Tq, Tq, stream);
  if (err != cudaSuccess) return err;
  const int group = (int)(BHq / BHkv);
  auto kv_kernel = dkdv_ffma_kernel<DH>;
  cudaError_t e = cudaFuncSetAttribute(kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (e != cudaSuccess) return (int)e;
  kv_kernel<<<(unsigned)(BHkv * n_kt), kFThreads, smem_kv, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, lse, delta, (float*)dk, (float*)dv,
      BHkv, Tq, Tk, Dh, group, causal, q_offset, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess || BHq * n_qt == 0) return (int)e;
  auto q_kernel = dq_ffma_kernel<DH>;
  e = cudaFuncSetAttribute(q_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  if (e != cudaSuccess) return (int)e;
  q_kernel<<<(unsigned)(BHq * n_qt), kFThreads, smem_q, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, lse, delta, (float*)dq, BHq, Tq, Tk,
      Dh, group, causal, q_offset, scale, (int)n_qt);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype 0 = float32 on route 0 (ffma, Dh 1..128); dtype 1 = bfloat16 on
// route 1 (wgmma, Dh 64 or 128, 16-byte aligned arrays). q, o, dout, dq
// [BHq, Tq, Dh]; k, v, dk, dv [BHkv, Tk, Dh]; lse [BHq, Tq] float32 from
// the forward and delta, float32 scratch, both with row stride ld values
// (route 0: ld = Tq; route 1: a multiple of 4, so that every row starts on
// 16 bytes for TMA). Route 1 also takes dq_acc
// ([BHq, ceil(Tq / 64) * 64, Dh] float32) and order (1 + BHq * ceil(Tq / 64)
// ints: the ticket, then the semaphores), both zeroed by the caller; route 0 ignores them. `scale`
// multiplies q.k. Three kernels on `stream`; returns the first CUDA error.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v, const void* o, const void* lse,
                               const void* dout, void* dq, void* dk, void* dv, void* delta, void* dq_acc, void* order,
                               long long BHq, long long BHkv, long long Tq, long long Tk, long long Dh, long long ld,
                               int causal, long long q_offset, float scale, int dtype, int route, void* stream) {
  if (BHkv <= 0 || BHq % BHkv != 0 || Tk <= 0 || Tq < 0 || q_offset < 0 || ld < Tq || ld <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* L = (const float*)lse;
  float* D = (float*)delta;
  if (route == 1) {
    if (dtype != 1 || dq_acc == nullptr || order == nullptr || ld % 4 != 0) return (int)cudaErrorInvalidValue;
    for (const void* p : {q, k, v, o, lse, dout, (const void*)dq, (const void*)dk, (const void*)dv,
                          (const void*)delta, (const void*)dq_acc})
      if ((uintptr_t)p % 16) return (int)cudaErrorMisalignedAddress;
    float* A = (float*)dq_acc;
    int* S = (int*)order;
    if (Dh == 64) return wgmma_launch<64>(q, k, v, o, L, dout, dq, dk, dv, D, A, S, BHq, BHkv, Tq, Tk, ld, causal, q_offset, scale, s);
    if (Dh == 128) return wgmma_launch<128>(q, k, v, o, L, dout, dq, dk, dv, D, A, S, BHq, BHkv, Tq, Tk, ld, causal, q_offset, scale, s);
    return (int)cudaErrorInvalidValue;
  }
  if (route != 0 || dtype != 0 || ld != Tq) return (int)cudaErrorInvalidValue;
  const int dh = (int)Dh;
  if (Dh >= 1 && Dh <= 32) return ffma_launch<32>(q, k, v, o, L, dout, dq, dk, dv, D, BHq, BHkv, Tq, Tk, dh, causal, q_offset, scale, s);
  if (Dh > 32 && Dh <= 64) return ffma_launch<64>(q, k, v, o, L, dout, dq, dk, dv, D, BHq, BHkv, Tq, Tk, dh, causal, q_offset, scale, s);
  if (Dh > 64 && Dh <= 128) return ffma_launch<128>(q, k, v, o, L, dout, dq, dk, dv, D, BHq, BHkv, Tq, Tk, dh, causal, q_offset, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
