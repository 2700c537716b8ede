// Fused cosine similarity + top-K over a tool table, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/topk_sim/kernel.py::topk_sim_pallas (body `_kernel`):
// scores q . t^T for [Q, D] queries against a [T, D] table and returns the
// k best (score, index) pairs per query, descending, ties to the lowest
// index as lax.top_k breaks them. The [Q, T] score matrix is never written
// to device memory.
//
// What bounds it on an H100 (SXM, 3.35 TB/s; 67 TFLOP/s float32 outside the
// tensor cores, 495 TFLOP/s TF32 on them): at the serving shape of 100,000
// tools x 384 dims the table is T*D*4 B = 153.6 MB, which takes 0.0459 ms to
// read once; 2*Q*T*D = 4.9 GFLOP at Q = 64 takes 0.0734 ms as float32 FMAs
// and ~0.010 ms as TF32 products. So on the CUDA cores Q >= ~40 is bound by
// FMA throughput, and on the tensor cores every batch is bound by the bytes.
// At the native 2,413 tools (3.7 MB, resident in L2) the bound is ~1-2 us
// and what costs is latency: launches, the chain of loads a block waits on,
// and merging.
//
// Three routes; the wrapper (topk_sim/kernel.py::topk_route) picks one
// before launch from shape and alignment, and none falls back to another.
//
// "split", for what the other two cannot take. The TPU grid walks the table
// axis in order on one core, carrying a running top-K in VMEM scratch; at
// serving batch sizes that is a single program, which on 132 SMs would
// leave 131 idle. So the work is cut in two passes:
//   pass 1, topk_sim_partial: grid (n_split, ceil(Q/QB)), about four blocks
//     per SM. A block streams its slice of the table in [TB, DK] chunks
//     (the next chunk's loads are in flight while the current one is
//     multiplied), computes each score with a float32 FMA chain over
//     d = 0..D-1 (no TF32: TF32 flips top-K indices), and after each tile
//     merges the tile's scores into a sorted top-k list per query in shared
//     memory. QB is 8 for batches of up to 8 queries, else 32. It writes the
//     lists to a [Q, n_split, k] scratch.
//   pass 2, topk_sim_merge: one block per query copies its n_split sorted
//     lists into shared memory and merges them with the same routine.
//
// "wgmma", for tables above CLUSTER_MAX_T rows with Q <= 64, k <= 32,
// D % 4 == 0, D >= 32 and 16-byte aligned bases (topk_route sends it
// batches of WGMMA_MIN_Q or more queries with Q * k <= WGMMA_MAX_QK, where
// it beat the split route on an H100): pass 1 is
// topk_sim_wgmma, pass 2 the same topk_sim_merge. The products run on the
// tensor cores in TF32, which only filters; every row that may still reach
// a query's top k is rescored in exact float32, so the result is bitwise
// the split route's.
//   Grid: n_split = min(SMs, MAX_CAND / k, ceil(T / 64)) blocks, about one
//     per SM, each a contiguous slice of whole 64-row tiles; all queries of
//     the batch in one block, so each table byte is read from HBM once.
//   Block: one producer warp and one or two consumer warpgroups (N = Q
//     padded to 8, 16, 32 or 64; above 8 two warpgroups of N / 2 queries
//     each: 288 threads). The queries sit in shared memory once, written by
//     the threads in TMA's 128-byte swizzle ([D/32] boxes of [N x 32]
//     float32, zeros past Q and D). The producer keeps a ring of
//     [64 rows x 32 float32] = 8 KB table boxes in flight with TMA
//     (mbarriers: `full` counts the bytes, `empty` every consumer; rows past
//     T and columns past D read as zeros). Each warpgroup computes
//     S^T[64 rows x N/2] = T_tile . Q_half^T with wgmma.m64nNk8.f32.tf32.tf32,
//     the table on the M side, both operands K-major (rows of D), four
//     k-steps of 32 bytes a box, and frees each box as soon as the product
//     that read it has completed (wait_group 1). The warpgroups then work
//     apart: each owns its queries' candidates and lists and has its own
//     named barrier.
//   Shared memory at Q = 64, D = 384: queries 12 x 8 KB = 96 KB; the ring
//     8 boxes at k = 5, 7 at k = 25 (56-64 KB); candidates 64 x 96 x 8 B =
//     48 KB; exact lists 64 x k x 8 B (2.5-16 KB); offer staging 8 KB;
//     bounds, norms, counts 1.3 KB; 1 KB of alignment slack: at most
//     227 KB (smem_bytes below; the wrapper picks the deepest ring that
//     fits, up to 24 boxes at Q <= 8).
//   Filter: in the registers that hold the scores, a row becomes a
//     candidate of query n if its TF32 score a >= thr[n] (NaN passes); it is
//     appended, unsorted, to the query's list of at most 96 (64-bit keys of
//     (a, row)). thr[n] = max(above(theta - E), v - 2E), theta the k-th
//     score of the query's exact list, v a lower bound on the k-th largest
//     a of some k distinct rows, E the margin below. k rows score a >= v,
//     so their exact scores and the slice's final k-th are >= v - E; and
//     the exact list's rows all come before the tile, so they win a tie:
//     a row can still enter only with an exact score s > theta. A row of the
//     slice's final top k therefore has a >= s - E >= v - 2E and
//     a >= s - E > theta - E (`above`: the next float up). No such row is
//     dropped. Before the first filter v is the k-th largest of the 32
//     maxima of disjoint row pairs of the first tile. E grows with M, the
//     largest row norm of the tiles seen so far (below), so thr is
//     computed from theta, v and M in every tile's filter: the k rows
//     behind v are from tiles already seen, within the E of their time (no
//     more than the current E), and a row of the tile is within the E that
//     includes it.
//   Compaction: a query holding more than 32 candidates after a tile (room
//     for another tile's 64 is needed) finds a lower bound within 2^-11
//     on its candidates' k-th largest a (a 20-step binary search on the
//     order-preserving score bits, counting with ballots), raises v to it
//     where it is higher, and keeps those >= v - 2E. If more than 32
//     near-ties remain, they are rescored into the exact list in a rescore
//     round.
//   Rescore round: the warpgroup's rescored candidates are numbered by a
//     prefix sum over its queries; each of its 128 threads prefetches its
//     rows into L2, then computes each pair's float32 FMA chain over
//     d = 0..D-1 (the query from the shared boxes, the row read back from
//     global memory): the split route's order, so the same float32 bits
//     (bar the sign of a zero, which pack_key folds). The owning warp offers
//     the exact keys to the query's exact list with `offer`. When the slice
//     is done every query's candidates >= v - 2E (about k of them on most
//     data) go through one round, so each slice's exact list holds exactly
//     the slice's top k keys and pass 2's merge is the split route's answer.
//     All-tied tables rescore every tied row, which is right. The count of
//     rescored (query, row) pairs goes to a device counter (`rescored` in
//     the wrapper).
//   Margin E, for any float32 inputs. wgmma reads a float32 operand as TF32
//     by dropping its low 13 mantissa bits (truncation: relative error
//     < 2^-10; a subnormal may be flushed). So, with s the FMA chain and a
//     the tensor-core score:
//       |sum q~t~ - sum qt| <= (2 * 2^-10 + 2^-20) sum|qt|;
//       the tensor core's float32 accumulation of the D exact products,
//       modelled as recursive summation with truncation (unit 2^-23) and
//       given 2D additions for D (PTX leaves its internal rounding
//       unspecified; the factor 2 is slack for that):
//       <= g(2D, 2^-23) sum|q~t~|, g(n, u) = nu / (1 - nu);
//       the FMA chain: |s - sum qt| <= g(D, 2^-24) sum|qt|;
//       sum|qt| <= |q| |t| <= |q| M (Cauchy-Schwarz), M the largest row
//       norm of the slice's tiles up to the row's own: each consumer thread
//       sums the squares of 16 of one row's 32 columns of every box as it
//       arrives (the box is in shared memory for the products anyway), and
//       a tile's largest norm is folded into M before its filter;
//       flushed subnormals and products below 2^-126: <= D 2^-126 (|q| + M + 1).
//     |q| and M are float32 square roots of float32 sums of squares, each
//     plus 2^-56: squares lost to underflow (subnormal or flushed) cost the
//     sum at most D 2^-126, the norm at most sqrt(D) 2^-63 <= 2^-58.
//     E = 0 for an all-zero query (both scores are exactly zero against a
//     finite row, and a non-finite row gives NaN, which passes): the zero
//     rows that pad a batch stop costing once their exact lists are full.
//     A NaN in a row makes M, so E and thr, NaN: every later row passes.
//     Else E = coef |q| M + abs_coef (|q| + M + 1), with coef = c(D) (1 + 2^-8) +
//     2^-20, c(D) = 2^-9 + 2^-20 + g(2D, 2^-23) (1 + 2^-10)^2 + g(D, 2^-24),
//     abs_coef = D 2^-126 (kernel.py::margin_coefs; 2.08e-3 at D = 384). The
//     (1 + 2^-8) covers the float32 rounding of |q| (summed here), of M and
//     of the product; 2^-20 |q| M the rounding of theta - E and v - 2E.
//     Nothing in it is tuned on data.
//
// "cluster", for tables of up to CLUSTER_MAX_T rows, in one launch:
// topk_sim_cluster, grid (CS, ceil(Q/QB)), one thread-block cluster of CS =
// 16 blocks (8 where 16 cannot be resident: cudaOccupancyMaxActiveClusters
// decides before the first launch) per block of QB queries. Block r of a
// cluster takes one contiguous slice of rows, so its slice is one byte
// range; a ring of up to four 32-row chunks in shared memory is filled by
// one cp.async.bulk a chunk, completing on the chunk's mbarrier (bytes by
// expect_tx, parity flipping on each reuse), all stages in flight from the
// start. Each of 8 warps scores 8 queries against 4 rows: lane l sums
// columns 4l + 128j of all 32 products, and a butterfly of shuffles adds
// the lanes' partial sums, so every product is summed over the same tree
// (identical rows tie bitwise). Each 128 rows go to the per-query lists.
// After cluster.sync() block r takes queries r, r + CS, ...: it copies that
// query's CS lists from its peers' shared memory (distributed shared
// memory), and each candidate's rank is its place in its own list plus the
// keys above it in the others (binary searches, skipped below the largest
// k-th key); ranks under k are written out. A second cluster.sync() keeps
// every block alive until its peers have read its lists. No scratch, no
// atomics: the result is deterministic. The bulk copies need D % 4 == 0 and
// 16-byte aligned bases; other inputs take the split route. Its summation
// order differs from cuBLAS's, as the split route's does: the two may order
// float32 near-ties differently.
//
// Every route keeps lists of 64-bit keys: the order-preserving bits of the
// score above (0xFFFFFFFF - row), so a larger key is a higher score or, on
// a tie, a lower row, and one integer compare gives lax.top_k's order. A
// merge keeps a threshold (the list's k-th key): only candidates above it
// are staged, and a staged batch is merged by rank counting.
//
// "select", for what the three above refuse: k > 128 (the gateway asks for
// C = 5k candidates when its re-ranker runs, 130 at k = 26) or D > 1024.
// It takes any k <= T and any D, as the Pallas kernel does, and is simple
// rather than fast: it only has to be right. Two launches:
//   pass 1, topk_sim_select_scores: grid (ceil(T/128), ceil(Q/8)); each
//     thread scores one row against 8 queries with the split route's
//     float32 FMA chain over d = 0..D-1 (chunks of 32 columns staged in
//     shared memory, so D has no upper limit) and writes the scores to a
//     [Q, T] float32 scratch: 4QT bytes more than the other routes move.
//   pass 2, topk_sim_select_topk: one block per query finds the k-th
//     largest 64-bit key (the same keys as above, so ties go to the lowest
//     row) by a radix select: eight passes over the row's T keys, each
//     counting the next 8 bits of the keys that match the prefix found so
//     far in a 256-bin shared histogram. Keys are distinct, so exactly k
//     keys are >= the k-th; they are compacted (a shared atomic counter)
//     into shared memory (k <= 4096) or into a [Q, pow2(k)] scratch, padded
//     with the key 0 (below every key of a row < 2^31 - 1) and sorted
//     descending by a block-wide bitonic sort.
//
// The empty-slot sentinel NEG_INF is an argument, passed from Python, so
// the port has one sentinel. Limits of the first three routes: k <= 128,
// D <= 1024, the split and wgmma routes' n_split*k <= 4096 (the wrapper
// checks them); the select route's: k <= T < 2^31 - 1.

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums only: nothing links libcuda
#include <cuda_runtime.h>

#include <cstdint>

#include "mbarrier.cuh"
#include "tma_wgmma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int TB = 128;        // table rows per tile
constexpr int DK = 32;         // depth of one staged chunk
constexpr int THREADS = 128;   // 4 warps
constexpr int WARPS = THREADS / 32;
constexpr int RPT = TB / 32;   // rows per thread (4)
constexpr int TS_STRIDE = TB + 1;  // conflict-free transposed stores
constexpr int TLOADS = TB * DK / THREADS;  // table floats a thread stages per chunk
constexpr int MAX_K = 128;
constexpr int MAX_D = 1024;
constexpr int MAX_CAND = 4096;
constexpr int KPL = MAX_K / 32;  // list entries per lane
constexpr int SMEM_OPT_IN = 227 * 1024;
constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ uint64_t pack_key(float s, uint32_t row) {
  uint32_t u = __float_as_uint(s);
  if ((u << 1) == 0) u = 0;  // -0.0 ties +0.0, as a float compare says
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<uint64_t>(u) << 32) | static_cast<uint64_t>(0xFFFFFFFFu - row);
}

__device__ __forceinline__ float key_score(uint64_t key) {
  uint32_t u = static_cast<uint32_t>(key >> 32);
  u = (u & 0x80000000u) ? (u & 0x7FFFFFFFu) : ~u;
  return __uint_as_float(u);
}

__device__ __forceinline__ uint32_t key_row(uint64_t key) {
  return 0xFFFFFFFFu - static_cast<uint32_t>(key);
}

// Merge n <= 128 staged keys S[0..n) (any order, distinct, none in L) into
// the descending list L[0..k) in shared memory, which then holds the k
// largest of both. L may repeat the empty key; its entries rank by
// position. Each key's rank in the union is counted, and keys ranked below
// k are written to their place. All 32 lanes of one warp call it.
__device__ __forceinline__ void merge_staged(uint64_t* L, int k, const uint64_t* S, int n,
                                             int lane) {
  uint64_t lv[KPL], sv[RPT];
  int lr[KPL], sr[RPT];
#pragma unroll
  for (int m = 0; m < KPL; ++m) {
    const int i = lane + 32 * m;
    lv[m] = i < k ? L[i] : 0ull;
    lr[m] = i;
  }
#pragma unroll
  for (int m = 0; m < RPT; ++m) {
    const int s = lane + 32 * m;
    sv[m] = s < n ? S[s] : 0ull;
    sr[m] = 0;
  }
  for (int j = 0; j < n; ++j) {
    const uint64_t x = S[j];
#pragma unroll
    for (int m = 0; m < KPL; ++m) lr[m] += x > lv[m];
#pragma unroll
    for (int m = 0; m < RPT; ++m) sr[m] += x > sv[m];
  }
  for (int i = 0; i < k; ++i) {
    const uint64_t x = L[i];
#pragma unroll
    for (int m = 0; m < RPT; ++m) sr[m] += x > sv[m];
  }
  __syncwarp();
#pragma unroll
  for (int m = 0; m < KPL; ++m)
    if (lane + 32 * m < k && lr[m] < k) L[lr[m]] = lv[m];
#pragma unroll
  for (int m = 0; m < RPT; ++m)
    if (lane + 32 * m < n && sr[m] < k) L[sr[m]] = sv[m];
  __syncwarp();
}

// Stage the candidates key_at(0..len) (len <= 128; 0 marks an absent
// slot) that beat L's k-th key into S, then merge them into L. While the
// list is still filling (many candidates pass), the threshold is first
// raised to the k-th largest of the lanes' maxima: those are k distinct
// candidates, so nothing below the k-th of them can reach the top k.
template <typename KeyAt>
__device__ __forceinline__ void offer(uint64_t* L, int k, uint64_t* S, int len, int lane,
                                      KeyAt key_at) {
  uint64_t thr = L[k - 1];
  uint64_t key[RPT];
  int n = 0;
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const int c = lane + 32 * j;
    key[j] = c < len ? key_at(c) : 0ull;
    n += __popc(__ballot_sync(FULL, key[j] > thr));
  }
  if (n == 0) return;  // warp-uniform
  if (k <= 32 && n > 2 * k) {
    uint64_t v = key[0];
#pragma unroll
    for (int j = 1; j < RPT; ++j) v = key[j] > v ? key[j] : v;
    // bitonic sort of the 32 lane maxima, descending across lanes
#pragma unroll
    for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        const uint64_t other = __shfl_xor_sync(FULL, v, stride);
        const bool keep_max = ((lane & stride) == 0) == ((lane & size) == 0);
        v = keep_max ? (v > other ? v : other) : (v < other ? v : other);
      }
    }
    const uint64_t kth = __shfl_sync(FULL, v, k - 1);
    if (kth > thr) thr = kth - 1;  // keep keys >= kth
  }
  n = 0;
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const bool pass = key[j] > thr;
    const unsigned ballot = __ballot_sync(FULL, pass);
    if (pass) S[n + __popc(ballot & ((1u << lane) - 1u))] = key[j];
    n += __popc(ballot);
  }
  __syncwarp();
  merge_staged(L, k, S, n, lane);
}

template <int QB>
struct Chunk {
  static constexpr int QLOADS = QB * DK / THREADS;  // query floats a thread stages
  float t[TLOADS];
  float q[QLOADS];

  // Read rows [tile, tile+TB) and queries [q0, q0+QB) at depth [d0, d0+DK)
  // into registers; a warp reads 128 contiguous bytes of one row per step.
  __device__ __forceinline__ void fetch(const float* __restrict__ queries,
                                        const float* __restrict__ table, int n_q, int d, int q0,
                                        int tile, int row_end, int d0, int tid) {
#pragma unroll
    for (int e = 0; e < TLOADS; ++e) {
      const int lin = tid + e * THREADS;
      const int row = tile + (lin >> 5);
      const int c = d0 + (lin & 31);
      t[e] = (row < row_end && c < d) ? __ldg(table + static_cast<size_t>(row) * d + c) : 0.0f;
    }
#pragma unroll
    for (int e = 0; e < QLOADS; ++e) {
      const int lin = tid + e * THREADS;
      const int qg = q0 + (lin >> 5);
      const int c = d0 + (lin & 31);
      q[e] = (qg < n_q && c < d) ? __ldg(queries + static_cast<size_t>(qg) * d + c) : 0.0f;
    }
  }

  // Store the registers transposed: t_s[c][r], q_s[c][query].
  __device__ __forceinline__ void stash(float* t_s, float* q_s, int tid) const {
    constexpr int QS_STRIDE = QB + 4;
#pragma unroll
    for (int e = 0; e < TLOADS; ++e) {
      const int lin = tid + e * THREADS;
      t_s[(lin & 31) * TS_STRIDE + (lin >> 5)] = t[e];
    }
#pragma unroll
    for (int e = 0; e < QLOADS; ++e) {
      const int lin = tid + e * THREADS;
      q_s[(lin & 31) * QS_STRIDE + (lin >> 5)] = q[e];
    }
  }
};

template <int QB>
constexpr size_t partial_smem_bytes(int k) {
  return sizeof(float) * (DK * (QB + 4) + DK * TS_STRIDE + QB * TB) +
         sizeof(uint64_t) * (WARPS * TB + static_cast<size_t>(QB) * k);
}

template <int QB>
__global__ void __launch_bounds__(THREADS) topk_sim_partial(
    const float* __restrict__ queries, const float* __restrict__ table, int n_q, int n_t,
    int d, int k, int rows_per_split, int n_split, float neg_inf,
    uint64_t* __restrict__ partial) {
  constexpr int QPT = QB / WARPS;  // queries per thread in the product
  constexpr int QS_STRIDE = QB + 4;  // keeps each depth row 16-byte aligned
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);  // [DK][QS_STRIDE]
  float* t_s = q_s + DK * QS_STRIDE;            // [DK][TS_STRIDE]
  float* sc_s = t_s + DK * TS_STRIDE;           // [QB][TB] scores of a tile
  uint64_t* stage = reinterpret_cast<uint64_t*>(sc_s + QB * TB);  // [WARPS][TB]
  uint64_t* lists = stage + WARPS * TB;                           // [QB][k]

  const int split = blockIdx.x;
  const int q0 = blockIdx.y * QB;
  const int row_begin = split * rows_per_split;
  const int row_end = min(row_begin + rows_per_split, n_t);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_chunks = (d + DK - 1) / DK;
  const int n_tiles = row_end > row_begin ? (row_end - row_begin + TB - 1) / TB : 0;
  const int total = n_tiles * n_chunks;

  const uint64_t empty = pack_key(neg_inf, 0xFFFFFFFFu);
  for (int i = tid; i < QB * k; i += THREADS) lists[i] = empty;

  Chunk<QB> chunk;
  if (total > 0) {
    chunk.fetch(queries, table, n_q, d, q0, row_begin, row_end, 0, tid);
    chunk.stash(t_s, q_s, tid);
  }
  __syncthreads();

  float acc[QPT][RPT];
#pragma unroll
  for (int i = 0; i < QPT; ++i)
#pragma unroll
    for (int j = 0; j < RPT; ++j) acc[i][j] = 0.0f;

  for (int it = 0; it < total; ++it) {
    const int tile = row_begin + (it / n_chunks) * TB;
    const bool has_next = it + 1 < total;
    if (has_next) {  // in flight while this chunk is multiplied
      const int nx = it + 1;
      chunk.fetch(queries, table, n_q, d, q0, row_begin + (nx / n_chunks) * TB, row_end,
                  (nx % n_chunks) * DK, tid);
    }
#pragma unroll 8
    for (int dd = 0; dd < DK; ++dd) {
      const float* qrow = q_s + dd * QS_STRIDE + warp * QPT;
      float a[QPT];
      if constexpr (QPT % 4 == 0) {
#pragma unroll
        for (int v = 0; v < QPT / 4; ++v) {
          const float4 x = reinterpret_cast<const float4*>(qrow)[v];
          a[4 * v] = x.x;
          a[4 * v + 1] = x.y;
          a[4 * v + 2] = x.z;
          a[4 * v + 3] = x.w;
        }
      } else {
#pragma unroll
        for (int v = 0; v < QPT / 2; ++v) {
          const float2 x = reinterpret_cast<const float2*>(qrow)[v];
          a[2 * v] = x.x;
          a[2 * v + 1] = x.y;
        }
      }
      float b[RPT];
#pragma unroll
      for (int j = 0; j < RPT; ++j) b[j] = t_s[dd * TS_STRIDE + lane + 32 * j];
#pragma unroll
      for (int i = 0; i < QPT; ++i)
#pragma unroll
        for (int j = 0; j < RPT; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // every warp is done with this chunk
    if (has_next) chunk.stash(t_s, q_s, tid);
    if (it % n_chunks == n_chunks - 1) {  // the tile's scores are complete
#pragma unroll
      for (int i = 0; i < QPT; ++i)
#pragma unroll
        for (int j = 0; j < RPT; ++j) {
          sc_s[(warp * QPT + i) * TB + lane + 32 * j] = acc[i][j];
          acc[i][j] = 0.0f;
        }
      __syncthreads();
      // warp w merges queries w, w+WARPS, ... so small batches use every warp
      const int len = min(TB, row_end - tile);
      for (int ql = warp; ql < QB && q0 + ql < n_q; ql += WARPS) {
        const float* sc = sc_s + ql * TB;
        offer(lists + ql * k, k, stage + warp * TB, len, lane,
              [&](int c) { return pack_key(sc[c], static_cast<uint32_t>(tile + c)); });
      }
    }
    __syncthreads();  // the next chunk is staged; sc_s reads are done
  }

  for (int i = tid; i < QB * k; i += THREADS) {
    const int ql = i / k;
    const int j = i - ql * k;
    const int qg = q0 + ql;
    if (qg < n_q) partial[(static_cast<size_t>(qg) * n_split + split) * k + j] = lists[i];
  }
}

// One block per query: copy its n_split sorted lists into shared memory;
// warp w merges lists w, w+WARPS, ... (a list whose head does not beat the
// running k-th key is skipped whole); warp 0 then merges the other warps'
// lists into its own and writes the result.
__global__ void __launch_bounds__(THREADS) topk_sim_merge(
    const uint64_t* __restrict__ partial, int n_split, int k, float neg_inf,
    float* __restrict__ out_scores, int64_t* __restrict__ out_idx) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_cand = n_split * k;
  uint64_t* cand = reinterpret_cast<uint64_t*>(smem);  // [n_split][k]
  uint64_t* lists = cand + n_cand;                      // [WARPS][k]
  uint64_t* stage = lists + WARPS * k;                  // [WARPS][MAX_K]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const uint64_t* src = partial + static_cast<size_t>(blockIdx.x) * n_cand;
  for (int i = tid; i < n_cand; i += THREADS) cand[i] = src[i];
  const uint64_t empty = pack_key(neg_inf, 0xFFFFFFFFu);
  for (int i = tid; i < WARPS * k; i += THREADS) lists[i] = empty;
  __syncthreads();

  uint64_t* L = lists + warp * k;
  uint64_t* S = stage + warp * MAX_K;
  for (int s = warp; s < n_split; s += WARPS) {
    const uint64_t* list = cand + s * k;
    if (list[0] <= L[k - 1]) continue;  // warp-uniform: nothing here can enter
    offer(L, k, S, k, lane, [&](int c) { return list[c]; });
  }
  __syncthreads();
  if (warp == 0) {
    for (int w = 1; w < WARPS; ++w) {
      const uint64_t* other = lists + w * k;
      offer(L, k, S, k, lane, [&](int c) { return other[c]; });
    }
    for (int i = lane; i < k; i += 32) {
      const uint64_t key = L[i];
      out_scores[static_cast<size_t>(blockIdx.x) * k + i] = key_score(key);
      out_idx[static_cast<size_t>(blockIdx.x) * k + i] = static_cast<int64_t>(key_row(key));
    }
  }
}

// ------------------------------------------------------------ cluster route
constexpr int CR = 32;          // table rows per ring chunk
constexpr int CTILE = 128;      // rows offered to the lists at once (4 chunks)
constexpr int MAX_STAGES = 4;
constexpr int BAR_BYTES = 128;  // mbarriers: one per stage and one for the queries
constexpr int CTHREADS = 256;   // 8 warps
constexpr int CWARPS = CTHREADS / 32;
constexpr int MAX_CS = 16;

constexpr size_t cluster_smem_bytes(int qb, int d, int k, int stages) {
  return BAR_BYTES + sizeof(float) * static_cast<size_t>(d) * (qb + stages * CR) +
         sizeof(float) * static_cast<size_t>(qb) * CTILE +
         sizeof(uint64_t) * (static_cast<size_t>(CWARPS) * MAX_K + static_cast<size_t>(qb) * k +
                             static_cast<size_t>(MAX_CS) * k);
}

// `bytes` (a multiple of 16) from 16-byte aligned global memory into shared
// memory, completing on `bar`, which expects them
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  mbar_expect_tx(bar, bytes);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// One step of lane_sums: lanes l and l ^ S trade halves of their first 2S
// partial sums, so each keeps S sums of two lanes' partials.
template <int S>
__device__ __forceinline__ void fold(float (&v)[32], int lane) {
  const bool upper = (lane & S) != 0;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const float send = upper ? v[i] : v[i + S];
    const float keep = upper ? v[i + S] : v[i];
    v[i] = keep + __shfl_xor_sync(FULL, send, S);
  }
}

// 32 per-lane partial sums v[0..32) of 32 dot products -> lane l returns the
// total of product l. Every product is summed over the same tree of lanes,
// so identical rows give bitwise identical scores.
__device__ __forceinline__ float lane_sums(float (&v)[32], int lane) {
  fold<16>(v, lane);
  fold<8>(v, lane);
  fold<4>(v, lane);
  fold<2>(v, lane);
  fold<1>(v, lane);
  return v[0];
}

// keys of the descending list L[0..k) greater than x
__device__ __forceinline__ int count_above(const uint64_t* L, int k, uint64_t x) {
  int lo = 0, hi = k;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (L[mid] > x) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

template <int QB>
__global__ void __launch_bounds__(CTHREADS) topk_sim_cluster(
    const float* __restrict__ queries, const float* __restrict__ table, int n_q, int n_t, int d,
    int k, int stages, float neg_inf, float* __restrict__ out_scores,
    int64_t* __restrict__ out_idx) {
  constexpr int WQ = QB / 8;        // warps across the queries, 8 queries each
  constexpr int WR = CWARPS / WQ;   // warps across the rows, 4 rows each
  constexpr int ROUND = 4 * WR;     // rows per round of all warps
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // [stages] chunks, [MAX_STAGES] queries
  float* q_s = reinterpret_cast<float*>(smem + BAR_BYTES);  // [QB][d]
  float* ring = q_s + QB * d;                              // [stages][CR][d]
  float* sc_s = ring + stages * CR * d;                    // [QB][CTILE]
  uint64_t* keys = reinterpret_cast<uint64_t*>(sc_s + QB * CTILE);  // [CWARPS][MAX_K]
  uint64_t* lists = keys + CWARPS * MAX_K;                          // [QB][k]
  uint64_t* cand = lists + QB * k;                                  // [MAX_CS][k]

  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int q0 = blockIdx.y * QB;
  const int nq = min(QB, n_q - q0);
  const int per = (n_t + cs - 1) / cs;
  const int row_begin = min(rank * per, n_t);
  const int n_rows = min(per, n_t - row_begin);
  const int n_chunks = (n_rows + CR - 1) / CR;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint32_t bar0 = smem_u32(bars);
  const uint32_t bar_q = bar0 + 8 * MAX_STAGES;
  const size_t chunk_floats = static_cast<size_t>(CR) * d;

  auto issue = [&](int c) {  // one thread: chunk c into stage c % stages
    const int rows = min(CR, n_rows - c * CR);
    bulk_load(smem_u32(ring + (c % stages) * chunk_floats),
              table + static_cast<size_t>(row_begin + c * CR) * d,
              static_cast<uint32_t>(rows) * d * sizeof(float), bar0 + 8 * (c % stages));
  };

  if (tid == 0) {
    for (int s = 0; s <= MAX_STAGES; ++s) mbar_init(bar0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    bulk_load(smem_u32(q_s), queries + static_cast<size_t>(q0) * d,
              static_cast<uint32_t>(nq) * d * sizeof(float), bar_q);
    for (int c = 0; c < min(stages, n_chunks); ++c) issue(c);
  }
  const uint64_t empty = pack_key(neg_inf, 0xFFFFFFFFu);
  for (int i = tid; i < QB * k; i += CTHREADS) lists[i] = empty;
  __syncthreads();  // barriers initialised, lists empty
  mbar_wait(bar_q, 0);

  // warp (qg, rg) scores its 8 queries against 4 rows of each round: lane l
  // sums the columns 4l + 128j of all 32 products, then lane_sums adds the
  // lanes' partial sums
  const int qg = warp % WQ, rg = warp / WQ;
  const float* qw = q_s + qg * 8 * d;
  const int n_slices = (d + 127) / 128;
  for (int c = 0; c < n_chunks; ++c) {
    mbar_wait(bar0 + 8 * (c % stages), (c / stages) & 1);
    const float* tc = ring + (c % stages) * chunk_floats;
    const int col0 = (c % (CTILE / CR)) * CR;  // this chunk's column in sc_s
    for (int r0 = rg * 4; r0 < CR; r0 += ROUND) {
      float acc[32];  // [query i][row j] partial sums of this lane's columns
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      for (int j = 0; j < n_slices; ++j) {
        const int col = 4 * lane + 128 * j;
        if (col < d) {
          float4 a[8], b[4];
#pragma unroll
          for (int i = 0; i < 8; ++i) a[i] = *reinterpret_cast<const float4*>(qw + i * d + col);
#pragma unroll
          for (int r = 0; r < 4; ++r)
            b[r] = *reinterpret_cast<const float4*>(tc + (r0 + r) * d + col);
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              float s = acc[i * 4 + r];
              s = fmaf(a[i].x, b[r].x, s);
              s = fmaf(a[i].y, b[r].y, s);
              s = fmaf(a[i].z, b[r].z, s);
              s = fmaf(a[i].w, b[r].w, s);
              acc[i * 4 + r] = s;
            }
        }
      }
      // lane l ends with product l: query l / 4, row l % 4
      const float s = lane_sums(acc, lane);
      sc_s[(qg * 8 + (lane >> 2)) * CTILE + col0 + r0 + (lane & 3)] = s;
    }
    __syncthreads();  // every warp is done with this stage; sc_s is written
    if (tid == 0 && c + stages < n_chunks) {
      // order this block's reads of the stage before the async refill
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(c + stages);
    }
    if (c % (CTILE / CR) == CTILE / CR - 1 || c == n_chunks - 1) {
      const int tile0 = (c / (CTILE / CR)) * CTILE;
      const int len = min(CTILE, n_rows - tile0);
      // warp w offers queries w, w+CWARPS, ...
      for (int ql = warp; ql < nq; ql += CWARPS) {
        const float* sc = sc_s + ql * CTILE;
        offer(lists + ql * k, k, keys + warp * MAX_K, len, lane, [&](int i) {
          return pack_key(sc[i], static_cast<uint32_t>(row_begin + tile0 + i));
        });
      }
      __syncthreads();  // sc_s is read before the next tile overwrites it
    }
  }

  // merge the cluster's lists: block r takes queries r, r + CS, ...; it
  // copies the CS sorted lists of that query from the peers' shared memory,
  // and each candidate's rank is its place in its own list plus the keys
  // above it in the others (binary searches); ranks below k are the result.
  // Keys are distinct but for the empty key, which ranks at or past the
  // table's k real keys.
  cluster.sync();
  for (int ql = rank; ql < nq; ql += cs) {
    for (int i = tid; i < cs * k; i += CTHREADS) {
      const int peer = i / k;
      cand[i] = cluster.map_shared_rank(lists, peer)[ql * k + i - peer * k];
    }
    __syncthreads();
    // every peer's k-th key has k keys at or above it: a key below the
    // largest of them ranks at or past k and needs no search
    uint64_t floor_key = cand[k - 1];
    for (int peer = 1; peer < cs; ++peer) floor_key = max(floor_key, cand[peer * k + k - 1]);
    const size_t out = static_cast<size_t>(q0 + ql) * k;
    for (int i = tid; i < cs * k; i += CTHREADS) {
      const int peer = i / k;
      const uint64_t x = cand[i];
      if (x < floor_key) continue;
      int r = i - peer * k;
      for (int other = 0; other < cs && r < k; ++other)
        if (other != peer) r += count_above(cand + other * k, k, x);
      if (r < k) {
        out_scores[out + r] = key_score(x);
        out_idx[out + r] = static_cast<int64_t>(key_row(x));
      }
    }
    __syncthreads();  // cand is read before the next query overwrites it
  }
  cluster.sync();  // no block leaves while a peer may still read its lists
}

template <int QB>
cudaLaunchConfig_t cluster_config(int cs, int n_q, size_t smem, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(cs, (n_q + QB - 1) / QB, 1);
  config.blockDim = dim3(CTHREADS, 1, 1);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return config;
}

// The cluster size to launch with: 16 where such a cluster can be resident
// at this shared memory, else 8, else 0.
template <int QB>
int cluster_plan(int d, int k, int stages, int* cs_out) {
  const size_t smem = cluster_smem_bytes(QB, d, k, stages);
  cudaError_t err = cudaFuncSetAttribute(topk_sim_cluster<QB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_OPT_IN);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(topk_sim_cluster<QB>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  *cs_out = 0;
  for (int cs : {16, 8}) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t config = cluster_config<QB>(cs, 1, smem, nullptr, &attr);
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, topk_sim_cluster<QB>, &config);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n >= 1) {
      *cs_out = cs;
      return 0;
    }
  }
  return 0;
}

template <int QB>
int launch_cluster(int cs, const void* queries, const void* table, int n_q, int n_t, int d, int k,
                   int stages, float neg_inf, void* out_scores, void* out_idx,
                   cudaStream_t stream) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t config =
      cluster_config<QB>(cs, n_q, cluster_smem_bytes(QB, d, k, stages), stream, &attr);
  const cudaError_t err = cudaLaunchKernelEx(
      &config, topk_sim_cluster<QB>, static_cast<const float*>(queries),
      static_cast<const float*>(table), n_q, n_t, d, k, stages, neg_inf,
      static_cast<float*>(out_scores), static_cast<int64_t*>(out_idx));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int QB>
int launch_partial(const void* queries, const void* table, int n_q, int n_t, int d, int k,
                   int n_split, int rows_per_split, float neg_inf, void* partial,
                   cudaStream_t stream) {
  static bool configured = false;  // raise the dynamic shared memory cap once
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        topk_sim_partial<QB>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_OPT_IN);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid(n_split, (n_q + QB - 1) / QB);
  topk_sim_partial<QB><<<grid, THREADS, partial_smem_bytes<QB>(k), stream>>>(
      static_cast<const float*>(queries), static_cast<const float*>(table), n_q, n_t, d, k,
      rows_per_split, n_split, neg_inf, static_cast<uint64_t*>(partial));
  return static_cast<int>(cudaGetLastError());
}

// -------------------------------------------------------------- wgmma route
namespace wr {

constexpr int ROWS = 64;                 // table rows per tile: wgmma's M
constexpr int BOXW = 32;                 // float32 columns of one 128B-swizzled box
constexpr int BOX_BYTES = ROWS * 128;    // one [64 x 32] table box: 8 KB
constexpr int CAND = 96;                 // TF32 candidates a query holds: room for a tile's 64
constexpr int MAX_K = 32;
constexpr int MIN_STAGES = 4;
constexpr int MAX_STAGES = 24;
constexpr uint64_t NO_KEY = 0;           // an empty slot, below every key (key_score: NaN)
constexpr float NORM_FLOOR = 0x1p-56f;   // added to |q| and M: squares lost to underflow

// dynamic shared memory of one block for n (padded) queries (as kernel.py)
constexpr size_t smem_bytes(int n, int d, int k, int stages) {
  const size_t nb = (d + BOXW - 1) / BOXW;
  return 1024                                     // slack to align the boxes to 1024 bytes
         + nb * n * 128                           // queries, [nb][n][32] float32
         + static_cast<size_t>(stages) * (BOX_BYTES + 16)  // the ring, its two mbarriers
         + 8 * (static_cast<size_t>(n) * (k + CAND) + (n >= 16 ? 8 : 4) * 128)  // lists, staging
         + 20 * static_cast<size_t>(n) + 48;  // bounds, norms, counts, rescore plan
}

// D[64 x N] (+)= A[64 x 8] B[8 x N], TF32 operands in shared memory (K-major)
__device__ __forceinline__ void mma(float (&d)[4], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {%0, %1, %2, %3}, %4, %5, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void mma(float (&d)[8], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void mma(float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void mma(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// the barrier of consumer warpgroup wg alone (the producer warp has left)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// whether `pred` holds on any thread of consumer warpgroup wg; a wg_sync too
__device__ __forceinline__ bool wg_any(int wg, bool pred) {
  uint32_t out;
  asm volatile(
      "{\n.reg .pred p, q;\nsetp.ne.u32 p, %1, 0;\nbar.red.or.pred q, %2, 128, p;\n"
      "selp.u32 %0, 1, 0, q;\n}\n"
      : "=r"(out)
      : "r"(static_cast<uint32_t>(pred)), "r"(1 + wg)
      : "memory");
  return out != 0;
}

// The least float above theta - e: a row of the current tile can enter an
// exact list whose k-th score is theta only with an exact score s > theta
// (the list's rows all come earlier, so they win a tie), and its TF32
// score a >= s - e then exceeds theta - e.
__device__ __forceinline__ float above(float theta, float e) {
  return nextafterf(theta - e, __uint_as_float(0x7f800000u));
}

// the larger of a and b, NaN if either is
__device__ __forceinline__ float max_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

// the k-th largest (k <= 32) of the 32 lanes' values, NaN-free, on every lane
__device__ __forceinline__ float kth_of_lanes(float v, int k, int lane) {
  // bitonic sort, descending across lanes
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const float other = __shfl_xor_sync(FULL, v, stride);
      const bool keep_max = ((lane & stride) == 0) == ((lane & size) == 0);
      v = keep_max ? fmaxf(v, other) : fminf(v, other);
    }
  }
  return __shfl_sync(FULL, v, k - 1);
}

// q . t as the split route computes it: one float32 FMA chain over
// d = 0..D-1 (D % 4 == 0), q read from the block's swizzled query boxes (row
// n of N) and t, 16-byte aligned, from global memory; the table loads run
// one group of G 16-byte units ahead of the chain
template <int N>
__device__ __forceinline__ float exact_dot(const uint8_t* q_s, int d, int n,
                                          const float* __restrict__ t) {
  constexpr int G = 8;
  const float4* t4 = reinterpret_cast<const float4*>(t);
  const uint8_t* qrow = q_s + n * 128;
  const int units = d / 4, sw = n & 7;
  float x = 0.f;
  float4 cur[G];
#pragma unroll
  for (int j = 0; j < G; ++j)
    if (j < units) cur[j] = __ldg(t4 + j);
  for (int u0 = 0; u0 < units; u0 += G) {
    float4 nxt[G];
#pragma unroll
    for (int j = 0; j < G; ++j)
      if (u0 + G + j < units) nxt[j] = __ldg(t4 + u0 + G + j);
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int u = u0 + j;
      if (u < units) {
        const float4 q = *reinterpret_cast<const float4*>(qrow + (u >> 3) * (N * 128) +
                                                          (((u & 7) ^ sw) << 4));
        x = fmaf(q.x, cur[j].x, x);
        x = fmaf(q.y, cur[j].y, x);
        x = fmaf(q.z, cur[j].z, x);
        x = fmaf(q.w, cur[j].w, x);
      }
    }
#pragma unroll
    for (int j = 0; j < G; ++j) cur[j] = nxt[j];
  }
  return x;
}

// NW query columns for each of WGS consumer warpgroups: N = NW * WGS queries
template <int NW, int WGS>
__global__ void __launch_bounds__(WGS * 128 + 32, 1) topk_sim_wgmma(
    const __grid_constant__ CUtensorMap tmap, const float* __restrict__ queries,
    const float* __restrict__ table, int n_q, int n_t, int d, int k, int rows_per_split,
    int n_split, int stages, float coef, float abs_coef,
    float neg_inf, uint64_t* __restrict__ partial, unsigned long long* __restrict__ rescored) {
  constexpr int N = NW * WGS;
  constexpr int CONS = WGS * 128;  // consumer threads
  constexpr int NT = CONS + 32;    // and the producer warp
  constexpr int NA = NW / 2;       // accumulators a thread
  extern __shared__ uint8_t smem_raw[];
  const int nb = (d + BOXW - 1) / BOXW;
  uint8_t* q_s = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);  // [nb][N][32]
  uint8_t* ring = q_s + nb * N * 128;                                // [stages][64][32]
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + stages * BOX_BYTES);  // full, empty
  uint64_t* lists = bars + 2 * stages;                               // [N][k] exact keys
  uint64_t* cand = lists + N * k;                                    // [N][CAND] TF32 keys
  uint64_t* stage = cand + N * CAND;                                 // [warps][128]
  float* vb = reinterpret_cast<float*>(stage + WGS * 4 * 128);  // [N] v: a lower bound on a
                                                                  // k-th TF32 score of k rows
  float* qn = vb + N;       // [N] |q| + NORM_FLOOR; -1 for an all-zero query (E = 0)
  int* cnt = reinterpret_cast<int*>(qn + N);                         // [N] candidates held
  int* fl = cnt + N;        // [N] candidates of each query to rescore this round (0: none)
  int* pre = fl + N;        // [N] their exclusive prefix sums within the warpgroup
  int* total_s = pre + N;   // [WGS] each warpgroup's round total (2 slots)
  float* wmax = reinterpret_cast<float*>(total_s + 2);  // [WGS][4] each warp's largest row norm

  const int tid = threadIdx.x, lane = tid & 31;
  const int split = blockIdx.x;
  const int row_begin = split * rows_per_split;
  const int row_end = min(row_begin + rows_per_split, n_t);
  const int n_tiles = (row_end - row_begin + ROWS - 1) / ROWS;
  const uint32_t bar_full = smem_u32(bars), bar_empty = bar_full + 8 * stages;
  const uint64_t empty = pack_key(neg_inf, 0xFFFFFFFFu);

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, CONS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the queries in TMA's 128-byte swizzle: 16-byte unit u of row n's 128
  // bytes in box b sits at unit u ^ (n % 8); zeros past n_q and past d
  const int units = nb * 8;
  for (int i = tid; i < N * units; i += NT) {
    const int n = i / units, u = i - n * units;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (n < n_q && 4 * u < d)
      v = __ldg(reinterpret_cast<const float4*>(queries + static_cast<size_t>(n) * d) + u);
    *reinterpret_cast<float4*>(q_s + (u >> 3) * (N * 128) + n * 128 + (((u & 7) ^ (n & 7)) << 4)) = v;
  }
  for (int i = tid; i < N * k; i += NT) lists[i] = empty;
  for (int n = tid >> 5; n < N; n += NT / 32) {  // each query's norm, for its margin E
    float s = 0.f, amax = 0.f;
    if (n < n_q)
      for (int c = lane; c < d; c += 32) {
        const float x = queries[static_cast<size_t>(n) * d + c];
        s = fmaf(x, x, s);
        amax = fmaxf(amax, fabsf(x));
      }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_xor_sync(FULL, s, o);
      amax = fmaxf(amax, __shfl_xor_sync(FULL, amax, o));
    }
    if (lane == 0) {
      // an all-zero query (the rows that pad a batch) scores exactly zero
      // both ways against every finite row: E = 0
      qn[n] = amax == 0.f ? -1.f : sqrtf(s) + NORM_FLOOR;
      cnt[n] = 0;
      fl[n] = 0;
    }
  }
  // the queries, written by threads, are read by wgmma through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  if (tid >= CONS) {
    // the producer warp: one lane issues every box of the slice, tile by tile
    if (tid == CONS) {
      const int total = n_tiles * nb;
      for (int i = 0; i < total; ++i) {
        const int s = i % stages;
        if (i >= stages) mbar_wait(bar_empty + 8 * s, ((i / stages) - 1) & 1);
        mbar_expect_tx(bar_full + 8 * s, BOX_BYTES);  // out-of-bounds parts count too
        const int t = i / nb, b = i - t * nb;
        tma_load_2d(smem_u32(ring + s * BOX_BYTES), &tmap, bar_full + 8 * s, b * BOXW,
                    row_begin + t * ROWS);
      }
    }
    return;
  }

  // consumer warpgroup wg owns queries [q_lo, q_hi): its products, filter,
  // candidates and lists; the warpgroups meet only at the ring's barriers
  const int wg = tid >> 7, wt = tid & 127, wl = wt >> 5, warp = tid >> 5;
  const int q_lo = wg * NW, q_hi = min(q_lo + NW, n_q);
  unsigned long long n_rescored = 0;  // thread wt == 0: the warpgroup's rescored pairs
  // [NW][32] before the first filter: row-group maxima, in the warpgroup's
  // own candidate slots (NW * 128 of its NW * CAND * 8 bytes)
  float* gmax = reinterpret_cast<float*>(cand + q_lo * CAND);
  float m_seen = 0.f;  // M: the largest row norm of the tiles seen so far (+ NORM_FLOOR)
  // query n's margin E at the current M
  auto margin = [&](int n) {
    const float x = qn[n];
    return x < 0.f ? 0.f : coef * x * m_seen + abs_coef * (x + m_seen + 1.f);
  };
  // query n's filter threshold: max(above(theta - E), v - 2E), theta the
  // exact list's k-th score, v = vb[n]
  auto threshold = [&](int n) {
    const float e = margin(n);
    return fmaxf(above(key_score(lists[n * k + k - 1]), e), vb[n] - 2.f * e);
  };

  // A lower bound, within 2^-11 relative, on the k-th largest TF32 score
  // among query n's c <= CAND candidates (NaN while there are fewer than
  // k): a binary search for the largest 20-bit prefix u of the
  // order-preserving score bits (a key's upper half) that k candidates
  // reach, counting with ballots, three candidates a lane; warp-wide.
  auto kth_candidate = [&](int n, int c) {
    if (c < k) return __uint_as_float(0x7fc00000u);
    uint32_t e[CAND / 32];
#pragma unroll
    for (int j = 0; j < CAND / 32; ++j) {
      const int i = lane + 32 * j;
      e[j] = i < c ? static_cast<uint32_t>(cand[n * CAND + i] >> 44) : 0u;
    }
    uint32_t lo = 0, hi = (1u << 20) - 1;  // k candidates reach lo
    while (lo < hi) {
      const uint32_t mid = (lo + hi + 1) >> 1;
      int reach = 0;
#pragma unroll
      for (int j = 0; j < CAND / 32; ++j) reach += __popc(__ballot_sync(FULL, e[j] >= mid));
      if (reach >= k) lo = mid;
      else hi = mid - 1;
    }
    return key_score(static_cast<uint64_t>(lo) << 44);
  };
  // Keep query n's candidates scoring >= floor_score, in place; returns how many.
  auto prune = [&](int n, int c, float floor_score) {
    int m = 0;
    for (int base = 0; base < c; base += 32) {
      const uint64_t key = base + lane < c ? cand[n * CAND + base + lane] : NO_KEY;
      const bool keep = key != NO_KEY && !(key_score(key) < floor_score);
      const unsigned ballot = __ballot_sync(FULL, keep);
      __syncwarp();
      if (keep) cand[n * CAND + m + __popc(ballot & ((1u << lane) - 1u))] = key;
      m += __popc(ballot);
    }
    __syncwarp();
    return m;
  };
  // One round of exact rescoring in warpgroup wg: query n's first fl[n]
  // candidates (each warp has set fl for its queries) are rescored by the
  // warpgroup's 128 threads, one a thread at a time, their keys replaced in place (the
  // rows prefetched into L2 first), then offered by the owning warp to the
  // query's exact list; the query is left with no candidates. Every thread
  // of the warpgroup calls it.
  auto rescore_round = [&]() {
    wg_sync(wg);
    if (wl == 0) {  // exclusive prefix sums of fl over the warpgroup's queries
      const int a = q_lo + lane < q_hi && lane < NW ? fl[q_lo + lane] : 0;
      int x = a;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL, x, o);
        if (lane >= o) x += y;
      }
      if (lane < NW) pre[q_lo + lane] = x - a;
      if (lane == 31) total_s[wg] = x;
    }
    wg_sync(wg);
    const int total = total_s[wg];
    auto locate = [&](int p, int& n, int& i) {  // the query and slot of pair p
      int lo = q_lo, hi = q_lo + NW - 1;
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (pre[mid] <= p) lo = mid;
        else hi = mid - 1;
      }
      n = lo;
      i = p - pre[lo];
    };
    for (int p = wt; p < total; p += 128) {  // bring the rows into L2 first
      int n, i;
      locate(p, n, i);
      const char* row = reinterpret_cast<const char*>(
          table + static_cast<size_t>(key_row(cand[n * CAND + i])) * d);
      for (int off = 0; off < d * 4; off += 128)
        asm volatile("prefetch.global.L2 [%0];\n" ::"l"(row + off));
    }
    for (int p = wt; p < total; p += 128) {
      int n, i;
      locate(p, n, i);
      const uint32_t row = key_row(cand[n * CAND + i]);
      cand[n * CAND + i] = pack_key(exact_dot<N>(q_s, d, n, table + static_cast<size_t>(row) * d), row);
    }
    if (wt == 0) n_rescored += total;
    wg_sync(wg);
    for (int n = q_lo + wl; n < q_hi; n += 4) {
      const int c = fl[n];
      if (c == 0) continue;  // warp-uniform
      offer(lists + n * k, k, stage + warp * 128, c, lane, [&](int i) { return cand[n * CAND + i]; });
      if (lane == 0) {
        cnt[n] = 0;
        fl[n] = 0;
      }
      __syncwarp();
    }
    wg_sync(wg);
  };

  float acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.f;
  // wgmma's fragment: tile rows fr, fr + 8; in each 8-column group, queries
  // q_lo + fc, q_lo + fc + 1
  const int fr = wl * 16 + (lane >> 2), fc = (lane & 3) * 2;
  const uint32_t q_base = smem_u32(q_s) + q_lo * 128, ring_base = smem_u32(ring);
  // the 16 columns of a box this thread squares for the tile's row norms:
  // units nu .. nu + 3 (16 bytes each, 128B-swizzled) of row nrow
  const int nrow = wt >> 1, nu = (wt & 1) * 4;

  for (int t = 0; t < n_tiles; ++t) {
    const int tile0 = row_begin + t * ROWS;
    const int len = min(ROWS, row_end - tile0);
    float sq[4] = {0.f, 0.f, 0.f, 0.f};  // this thread's part of row nrow's sum of squares
    wgmma_fence();
    for (int b = 0; b < nb; ++b) {
      const int i = t * nb + b, s = i % stages;
      mbar_wait(bar_full + 8 * s, (i / stages) & 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // four k-steps of 8 float32 (32 bytes) a box
        mma(acc, smem_desc(ring_base + s * BOX_BYTES + kk * 32, 16, 1024),
            smem_desc(q_base + b * N * 128 + kk * 32, 16, 1024), (b | kk) != 0);
      wgmma_commit();
      const uint8_t* box_row = ring + s * BOX_BYTES + nrow * 128;
#pragma unroll
      for (int u = 0; u < 4; ++u) {  // rows past T and columns past D read as zeros
        const float4 x = *reinterpret_cast<const float4*>(box_row + (((nu + u) ^ (nrow & 7)) << 4));
        sq[0] = fmaf(x.x, x.x, sq[0]);
        sq[1] = fmaf(x.y, x.y, sq[1]);
        sq[2] = fmaf(x.z, x.z, sq[2]);
        sq[3] = fmaf(x.w, x.w, sq[3]);
      }
      if (b > 0) {  // the previous box's products are done: free its slot
        wgmma_wait_one();
        mbar_arrive(bar_empty + 8 * ((i - 1) % stages));
      }
    }
    wgmma_wait_all();
    mbar_arrive(bar_empty + 8 * (((t + 1) * nb - 1) % stages));
    pin(acc);

    // the tile's largest row norm, folded into M (NaN if a row holds one)
    const float part = (sq[0] + sq[1]) + (sq[2] + sq[3]);
    float rn = sqrtf(part + __shfl_xor_sync(FULL, part, 1));
#pragma unroll
    for (int o = 2; o < 32; o <<= 1) rn = max_nan(rn, __shfl_xor_sync(FULL, rn, o));
    if (lane == 0) wmax[wg * 4 + wl] = rn;
    if (t == 0) {
      // the first v: the k-th largest of the 32 maxima of disjoint row
      // groups (a thread's two rows), so k distinct rows score a >= v
      const float minus_inf = __uint_as_float(0xff800000u);
#pragma unroll
      for (int j = 0; j < NW / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float a = acc[4 * j + h], b = acc[4 * j + 2 + h];
          gmax[(8 * j + fc + h) * 32 + wl * 8 + (lane >> 2)] =
              fmaxf(fr < len && a == a ? a : minus_inf, fr + 8 < len && b == b ? b : minus_inf);
        }
      }
    }
    wg_sync(wg);
    m_seen = max_nan(m_seen, max_nan(max_nan(wmax[wg * 4], wmax[wg * 4 + 1]),
                                     max_nan(wmax[wg * 4 + 2], wmax[wg * 4 + 3])) + NORM_FLOOR);
    if (t == 0) {
      for (int n = q_lo + wl; n < q_hi; n += 4) {
        const float v = kth_of_lanes(gmax[(n - q_lo) * 32 + lane], k, lane);
        if (lane == 0) vb[n] = v;
      }
      wg_sync(wg);
    }
    // filter, in the registers that hold the scores: a row whose TF32 score
    // a >= the query's threshold at the new M becomes a candidate (at most a
    // tile's 64 rows a query: each list has that much room)
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      float thr[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int q = q_lo + 8 * j + fc + c;
        thr[c] = q < q_hi ? threshold(q) : 0.f;
      }
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int r = fr + (h >> 1) * 8, q = q_lo + 8 * j + fc + (h & 1);
        const float a = acc[4 * j + h];
        if (r < len && q < q_hi && !(a < thr[h & 1])) {
          const int slot = atomicAdd(cnt + q, 1);
          cand[q * CAND + slot] = pack_key(a, static_cast<uint32_t>(tile0 + r));
        }
      }
    }
    wg_sync(wg);
    // a query whose candidates could not take another tile raises v to their
    // k-th TF32 score and keeps those at or above v - 2E; if too many
    // near-ties remain, they are rescored into the exact list
    bool any = false;
    for (int n = q_lo + wl; n < q_hi; n += 4) {
      int c = cnt[n];
      if (c <= CAND - ROWS) continue;  // warp-uniform
      const float v = fmaxf(vb[n], kth_candidate(n, c));
      c = prune(n, c, v - 2.f * margin(n));
      any |= c > CAND - ROWS;
      if (lane == 0) {
        vb[n] = v;
        cnt[n] = c;
        if (c > CAND - ROWS) fl[n] = c;
      }
      __syncwarp();
    }
    if (wg_any(wg, any)) rescore_round();  // counts set for the next tile
  }

  // the slice is done: each query's candidates at or above v - 2E are
  // rescored and offered
  for (int n = q_lo + wl; n < q_hi; n += 4) {
    const int c0 = cnt[n];
    const int c = prune(n, c0, fmaxf(vb[n], kth_candidate(n, c0)) - 2.f * margin(n));
    if (lane == 0) fl[n] = c;
    __syncwarp();
  }
  rescore_round();
  for (int i = wt; i < (q_hi - q_lo) * k; i += 128) {
    const int n = q_lo + i / k;
    partial[(static_cast<size_t>(n) * n_split + split) * k + i % k] = lists[n * k + i % k];
  }
  if (wt == 0 && n_rescored) atomicAdd(rescored, n_rescored);
}

// the table [n_t, d] float32, contiguous, read as [64 rows x 32 columns]
// boxes in 128B swizzle; rows past n_t and columns past d read as zeros
cudaError_t make_map(EncodeTiled encode, CUtensorMap* map, const void* table, int n_t, int d) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(n_t)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d) * 4};
  const cuuint32_t box[2] = {BOXW, ROWS};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(table),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int NW, int WGS>
int launch(const void* queries, const void* table, int n_q, int n_t, int d, int k, int n_split,
           int rows_per_split, int stages, float coef, float abs_coef, float neg_inf,
           void* partial, void* rescored, cudaStream_t stream) {
  static const EncodeTiled encode = load_encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap map;
  cudaError_t err = make_map(encode, &map, table, n_t, d);
  if (err != cudaSuccess) return static_cast<int>(err);
  static bool configured = false;  // raise the dynamic shared memory cap once
  if (!configured) {
    err = cudaFuncSetAttribute(topk_sim_wgmma<NW, WGS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_OPT_IN);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  topk_sim_wgmma<NW, WGS><<<n_split, WGS * 128 + 32, smem_bytes(NW * WGS, d, k, stages), stream>>>(
      map, static_cast<const float*>(queries), static_cast<const float*>(table), n_q, n_t, d, k,
      rows_per_split, n_split, stages, coef, abs_coef, neg_inf, static_cast<uint64_t*>(partial),
      static_cast<unsigned long long*>(rescored));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wr

// ------------------------------------------------------------- select route
namespace sel {

constexpr int QB = 8;             // pass 1: queries a block
constexpr int ROWS = 128;         // pass 1: rows a block, one a thread
constexpr int DK = 32;            // pass 1: columns staged at once
constexpr int THREADS = 512;      // pass 2
constexpr int SMEM_KEYS = 4096;   // pass 2 sorts up to this many keys in shared memory

__global__ void __launch_bounds__(ROWS) topk_sim_select_scores(
    const float* __restrict__ queries, const float* __restrict__ table, int n_q, int n_t, int d,
    float* __restrict__ scores) {
  __shared__ float q_s[QB][DK];
  __shared__ float t_s[ROWS][DK + 1];  // odd stride: a thread's row, conflict-free
  const int tid = threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * ROWS;
  const int q0 = blockIdx.y * QB;
  float acc[QB];
#pragma unroll
  for (int i = 0; i < QB; ++i) acc[i] = 0.0f;
  for (int d0 = 0; d0 < d; d0 += DK) {
    // a warp reads 32 consecutive columns of one row per step
    for (int e = tid; e < ROWS * DK; e += ROWS) {
      const int r = e / DK, c = e % DK;
      const long long row = row0 + r;
      t_s[r][c] = (row < n_t && d0 + c < d) ? __ldg(table + row * d + d0 + c) : 0.0f;
    }
    for (int e = tid; e < QB * DK; e += ROWS) {
      const int i = e / DK, c = e % DK;
      q_s[i][c] = (q0 + i < n_q && d0 + c < d)
                      ? __ldg(queries + static_cast<long long>(q0 + i) * d + d0 + c)
                      : 0.0f;
    }
    __syncthreads();
    const int nc = min(DK, d - d0);
    for (int c = 0; c < nc; ++c) {  // the split route's chain: d = 0..D-1 in order
      const float tv = t_s[tid][c];
#pragma unroll
      for (int i = 0; i < QB; ++i) acc[i] = fmaf(q_s[i][c], tv, acc[i]);
    }
    __syncthreads();
  }
  const long long row = row0 + tid;
  if (row < n_t) {
#pragma unroll
    for (int i = 0; i < QB; ++i)
      if (q0 + i < n_q) scores[static_cast<long long>(q0 + i) * n_t + row] = acc[i];
  }
}

// Sort x[0..p) descending (p a power of two) with a bitonic network; every
// thread of the block calls it. x is in shared or in global memory: the
// barrier between steps orders both for the block.
__device__ void bitonic_sort_desc(uint64_t* x, int p) {
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < p / 2; i += blockDim.x) {
        const int lo = 2 * stride * (i / stride) + (i % stride);
        const int hi = lo + stride;
        const bool desc = (lo & size) == 0;
        const uint64_t a = x[lo], b = x[hi];
        if (desc ? a < b : a > b) {
          x[lo] = b;
          x[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

// One block per query: radix-select the k-th largest key of the row's T
// scores, compact the k keys >= it, sort them, write (score, row) pairs.
// `sorted` is a [Q, p] scratch used only when p > SMEM_KEYS.
__global__ void __launch_bounds__(THREADS) topk_sim_select_topk(
    const float* __restrict__ scores, int n_t, int k, int p, uint64_t* __restrict__ sorted,
    float* __restrict__ out_scores, int64_t* __restrict__ out_idx) {
  __shared__ unsigned hist[256];
  __shared__ uint64_t prefix_s;
  __shared__ int remaining_s;
  __shared__ unsigned count_s;
  __shared__ uint64_t keys_s[SMEM_KEYS];
  const int tid = threadIdx.x;
  const long long qi = blockIdx.x;
  const float* row = scores + qi * n_t;

  uint64_t prefix = 0, mask = 0;
  int remaining = k;  // the wanted key's rank among the keys that match `prefix`
  for (int shift = 56; shift >= 0; shift -= 8) {
    for (int i = tid; i < 256; i += THREADS) hist[i] = 0;
    __syncthreads();
    for (int i = tid; i < n_t; i += THREADS) {
      const uint64_t key = pack_key(row[i], static_cast<uint32_t>(i));
      if ((key & mask) == prefix) atomicAdd(&hist[(key >> shift) & 255u], 1u);
    }
    __syncthreads();
    if (tid == 0) {
      int b = 255, r = remaining;
      while (static_cast<int>(hist[b]) < r) {  // the counts above sum to >= r
        r -= static_cast<int>(hist[b]);
        --b;
      }
      prefix_s = prefix | (static_cast<uint64_t>(b) << shift);
      remaining_s = r;
    }
    __syncthreads();
    prefix = prefix_s;
    remaining = remaining_s;
    mask |= static_cast<uint64_t>(255) << shift;
  }
  // prefix is now the k-th largest key; exactly k keys are >= it

  uint64_t* x = p <= SMEM_KEYS ? keys_s : sorted + qi * p;
  if (tid == 0) count_s = 0;
  for (int i = k + tid; i < p; i += THREADS) x[i] = 0ull;
  __syncthreads();
  for (int i = tid; i < n_t; i += THREADS) {
    const uint64_t key = pack_key(row[i], static_cast<uint32_t>(i));
    if (key >= prefix) {
      const unsigned slot = atomicAdd(&count_s, 1u);
      if (slot < static_cast<unsigned>(k)) x[slot] = key;
    }
  }
  __syncthreads();
  bitonic_sort_desc(x, p);
  for (int i = tid; i < k; i += THREADS) {
    const uint64_t key = x[i];
    out_scores[qi * k + i] = key_score(key);
    out_idx[qi * k + i] = static_cast<int64_t>(key_row(key));
  }
}

}  // namespace sel

}  // namespace

extern "C" {

// Pass 1. Pointers are device pointers on `device`; `stream` is a
// cudaStream_t; `qb` (8 or 32) is the number of queries per block. Returns
// the launch's cudaError_t (0 on success).
int topk_sim_partial_launch(int device, int qb, const void* queries, const void* table, int n_q,
                            int n_t, int d, int k, int n_split, int rows_per_split,
                            float neg_inf, void* partial, void* stream) {
  if (k < 1 || k > MAX_K || d < 1 || d > MAX_D || n_split * k > MAX_CAND) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  if (qb == 8) return launch_partial<8>(queries, table, n_q, n_t, d, k, n_split, rows_per_split, neg_inf, partial, s);
  if (qb == 32) return launch_partial<32>(queries, table, n_q, n_t, d, k, n_split, rows_per_split, neg_inf, partial, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Pass 2: one block per query merges its n_split lists of k candidates.
int topk_sim_merge_launch(int device, const void* partial, int n_q, int n_split, int k,
                          float neg_inf, void* out_scores, void* out_idx, void* stream) {
  if (k < 1 || k > MAX_K || n_split < 1 || n_split * k > MAX_CAND) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  static bool configured = false;
  if (!configured) {
    err = cudaFuncSetAttribute(topk_sim_merge, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_OPT_IN);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const size_t smem = sizeof(uint64_t) * (static_cast<size_t>(n_split) * k + WARPS * k + WARPS * MAX_K);
  topk_sim_merge<<<n_q, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(partial), n_split, k, neg_inf, static_cast<float*>(out_scores),
      static_cast<int64_t*>(out_idx));
  return static_cast<int>(cudaGetLastError());
}

// The cluster route's size for `qb` (8, 16 or 32) queries a block at this
// D, k and ring depth: writes 16 or 8 to *cs, or 0 where neither cluster can
// be resident. Sets the kernel's attributes; call before the first launch.
int topk_sim_cluster_plan(int device, int qb, int d, int k, int stages, int* cs) {
  if (k < 1 || k > MAX_K || d < 4 || d % 4 != 0 || stages < 2 || stages > MAX_STAGES ||
      cluster_smem_bytes(qb, d, k, stages) > static_cast<size_t>(SMEM_OPT_IN)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (qb == 8) return cluster_plan<8>(d, k, stages, cs);
  if (qb == 16) return cluster_plan<16>(d, k, stages, cs);
  if (qb == 32) return cluster_plan<32>(d, k, stages, cs);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The cluster route in one launch: grid (cs, ceil(n_q / qb)), clusters of
// cs blocks. queries and table 16-byte aligned, D % 4 == 0 (bulk copies).
int topk_sim_cluster_launch(int device, int qb, int cs, const void* queries, const void* table,
                            int n_q, int n_t, int d, int k, int stages, float neg_inf,
                            void* out_scores, void* out_idx, void* stream) {
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (k < 1 || k > MAX_K || d < 4 || d % 4 != 0 || (cs != 8 && cs != 16) || stages < 2 ||
      stages > MAX_STAGES || n_q < 1 || n_t < k || !aligned(queries) || !aligned(table) ||
      cluster_smem_bytes(qb, d, k, stages) > static_cast<size_t>(SMEM_OPT_IN)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  if (qb == 8) return launch_cluster<8>(cs, queries, table, n_q, n_t, d, k, stages, neg_inf, out_scores, out_idx, s);
  if (qb == 16) return launch_cluster<16>(cs, queries, table, n_q, n_t, d, k, stages, neg_inf, out_scores, out_idx, s);
  if (qb == 32) return launch_cluster<32>(cs, queries, table, n_q, n_t, d, k, stages, neg_inf, out_scores, out_idx, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The wgmma route's pass 1 (pass 2 is topk_sim_merge_launch): n_split
// blocks of rows_per_split rows (a multiple of 64) for n_q <= n_pad queries
// (n_pad 8, 16, 32 or 64). queries and table 16-byte aligned, D % 4 == 0,
// 32 <= D; rescored at an unsigned 64-bit counter the kernel adds its rescored
// (query, row) pairs to. Returns the tensor-map encode's or the launch's
// cudaError_t (0 on success).
int topk_sim_wgmma_launch(int device, int n_pad, const void* queries, const void* table, int n_q,
                          int n_t, int d, int k, int n_split, int rows_per_split, int stages,
                          float coef, float abs_coef, float neg_inf, void* partial,
                          void* rescored, void* stream) {
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (k < 1 || k > wr::MAX_K || d < wr::BOXW || d > MAX_D || d % 4 != 0 || n_q < 1 ||
      n_q > n_pad || n_split < 1 || n_split * k > MAX_CAND || rows_per_split < wr::ROWS ||
      rows_per_split % wr::ROWS != 0 ||
      static_cast<long long>(n_split) * rows_per_split < n_t ||
      static_cast<long long>(n_split - 1) * rows_per_split >= n_t || stages < wr::MIN_STAGES ||
      stages > wr::MAX_STAGES || !aligned(queries) || !aligned(table) ||
      wr::smem_bytes(n_pad, d, k, stages) > static_cast<size_t>(SMEM_OPT_IN)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  if (n_pad == 8) return wr::launch<8, 1>(queries, table, n_q, n_t, d, k, n_split, rows_per_split, stages, coef, abs_coef, neg_inf, partial, rescored, s);
  if (n_pad == 16) return wr::launch<8, 2>(queries, table, n_q, n_t, d, k, n_split, rows_per_split, stages, coef, abs_coef, neg_inf, partial, rescored, s);
  if (n_pad == 32) return wr::launch<16, 2>(queries, table, n_q, n_t, d, k, n_split, rows_per_split, stages, coef, abs_coef, neg_inf, partial, rescored, s);
  if (n_pad == 64) return wr::launch<32, 2>(queries, table, n_q, n_t, d, k, n_split, rows_per_split, stages, coef, abs_coef, neg_inf, partial, rescored, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The select route's pass 1: scores [n_q, n_t] float32 by the FMA chain.
int topk_sim_select_scores_launch(int device, const void* queries, const void* table, int n_q,
                                  int n_t, int d, void* scores, void* stream) {
  if (n_q < 1 || n_t < 1 || d < 1 || (n_q + sel::QB - 1) / sel::QB > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_t + sel::ROWS - 1) / sel::ROWS, (n_q + sel::QB - 1) / sel::QB);
  sel::topk_sim_select_scores<<<grid, sel::ROWS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(queries), static_cast<const float*>(table), n_q, n_t, d,
      static_cast<float*>(scores));
  return static_cast<int>(cudaGetLastError());
}

// The select route's pass 2: one block per query over its n_t scores; p is
// k rounded up to a power of two, `sorted` a [n_q, p] uint64 scratch read
// only when p > 4096 (may be any pointer otherwise).
int topk_sim_select_topk_launch(int device, const void* scores, int n_q, int n_t, int k, int p,
                                void* sorted, void* out_scores, void* out_idx, void* stream) {
  if (n_q < 1 || k < 1 || k > n_t || p < k || (p & (p - 1)) != 0 || p > (1 << 30)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  sel::topk_sim_select_topk<<<n_q, sel::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scores), n_t, k, p, static_cast<uint64_t*>(sorted),
      static_cast<float*>(out_scores), static_cast<int64_t*>(out_idx));
  return static_cast<int>(cudaGetLastError());
}

const char* topk_sim_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
