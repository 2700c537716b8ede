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
// It takes any k <= T and any D, as the Pallas kernel does. Two launches,
// both sized by topk_sim/kernel.py::select_plan from the shapes alone:
//   pass 1, topk_sim_select_scores: register-tiled float32 FMA chains. A
//     block scores BQ queries against BR rows (tiles of 8-64 x 32-128 and at
//     most 256 threads, the largest whose grid still gives every SM a
//     block; two blocks fit an SM), each thread a 4 x 4
//     micro-tile: 16 independent chains, each the split route's
//     acc = fmaf(q[d], t[d], acc) over d = 0..D-1 in order, so the scores
//     are the split route's bits (no tensor cores, no reordered sum). Chunks
//     of 64 columns of the block's queries and rows arrive through a ring of
//     up to four buffers, each completing on its mbarrier: four bulk tensor
//     copies (two 32-column boxes of each) where D % 4 == 0 and both bases
//     are 16-byte aligned, else every thread's 4-byte cp.async. Rows sit in
//     TMA's 128-byte swizzle, so one float4 read feeds four steps of each of
//     a row's four chains without bank conflicts. At the re-ranker's shape
//     (64 x 2,413 x 384) the grid is 152 blocks of two warps: each thread's
//     6,144 dependent-chain FMAs, not the bytes, bound it. The scores go to
//     a [Q, T] float32 scratch: 4QT bytes more than the other routes move.
//   pass 2, topk_sim_select_topk: a thread-block cluster of CS blocks (1 to
//     16) a query, each holding a slice of the query's scores as pack_key's
//     upper 32 bits in its own shared memory, read once (past what 16
//     blocks hold, the rest of a slice is read again from the scratch in
//     each pass); 512 threads a block, 1,024 for a slice of 16,384 keys or
//     more, whose block has its SM to itself and is bound by the latency of
//     each thread's pass over its keys. Four 8-bit radix passes over those
//     score bits find the k-th largest score: each block counts its keys
//     that match the prefix found so far (a thread counts a run of keys in
//     one bin and adds it by one shared atomic when the bin changes: a few
//     atomics a thread where scores share their top byte; on an H100 this
//     beat one atomic per distinct bin a warp found by __match_any_sync),
//     the blocks sum the cluster's histograms in distributed shared memory,
//     and warp 0 finds the bin by a suffix scan of shuffles; a pass that
//     leaves exactly as many matching keys as are still wanted ends the
//     search. Every key above the threshold score goes in; of the keys
//     equal to it, the `remaining` lowest rows, counted in row order
//     (thread order in a block, an exclusive scan; rank order across the
//     cluster's blocks, from the last pass's histograms), so ties go to the
//     lowest row as in lax.top_k. The k survivors, as pack_key's 64-bit
//     keys, gather in the leader block's shared memory (remote atomics hand
//     out the slots) and are placed by rank counting: a key's place is the
//     count of keys above it, S threads counting for one key where k S is at
//     most the block's threads. Past SEL_SMEM_KEYS = 4,096 they gather in a
//     [Q, pow2(k)] scratch, padded with the key 0, and the leader sorts them
//     by a bitonic network.
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

// the order-preserving 32 bits of a score
__device__ __forceinline__ uint32_t score_key(float s) {
  uint32_t u = __float_as_uint(s);
  if ((u << 1) == 0) u = 0;  // -0.0 ties +0.0, as a float compare says
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ uint64_t pack_key(float s, uint32_t row) {
  return (static_cast<uint64_t>(score_key(s)) << 32) |
         static_cast<uint64_t>(0xFFFFFFFFu - row);
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

constexpr int BOX = 32;          // pass 1: columns of a tensor copy's box (128-byte rows)
constexpr int DC = 2 * BOX;      // pass 1: depth of one ring chunk, two boxes
constexpr int MAX_STAGES = 4;    // pass 1: ring depth
constexpr int MAX_THREADS = 1024;  // pass 2: 512 or 1024 threads a block
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int SMEM_KEYS = 4096;  // pass 2 ranks up to this many keys in the leader's shared memory
constexpr int MAX_CS = 16;
constexpr int BINS = 256;
constexpr int PASSES = 4;        // 8 bits each over the 32 score bits
constexpr int UNROLL = 4;        // pass 2: keys a thread takes at once in a histogram
// pass 2's shared memory besides the survivors and the slice: the four
// passes' histograms, their cluster totals, the scan's warp sums, four ints
constexpr int FIXED_BYTES = 4 * (PASSES * BINS + BINS + MAX_WARPS + 4);

// mbarriers, 1 KB of slack to align the ring, the ring
constexpr size_t scores_smem_bytes(int bq, int br, int stages) {
  return BAR_BYTES + 1024 + sizeof(float) * static_cast<size_t>(stages) * (bq + br) * DC;
}

constexpr size_t topk_smem_bytes(int k, int cap) {
  return (k <= SMEM_KEYS ? sizeof(uint64_t) * static_cast<size_t>(k) : 0) + FIXED_BYTES +
         sizeof(uint32_t) * static_cast<size_t>(cap);
}

// [rows, d] float32 read as boxes of [box_rows x BOX] in 128-byte swizzle;
// rows past `rows` and columns past d read as zeros
cudaError_t make_map(EncodeTiled encode, CUtensorMap* map, const void* base, int rows, int d,
                     int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d) * 4};
  const cuuint32_t box[2] = {BOX, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// one float, or four zero bytes where `n` is 0, from any global address
__device__ __forceinline__ void copy4(uint32_t dst, const float* src, int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(n)
               : "memory");
}

// this thread's cp.async copies so far arrive on `bar` when they land
__device__ __forceinline__ void copies_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// Pass 1: scores [Q, T] by the split route's float32 chain. A block scores
// BQ queries against BR rows; each thread a 4 x 4 micro-tile (queries
// tq + QT i, rows tr + RT j), 16 independent chains. The warps' lanes sit
// LR across rows by LQ across queries, so a warp's float4 reads of a depth
// step hit LR rows and LQ queries. Chunks of DC columns of the block's
// queries and rows arrive in a ring of `stages` buffers, each completing on
// its mbarrier: by four bulk tensor copies, a box of BOX columns of the
// queries and one of the rows for each half (`tma`: D % 4 == 0 and 16-byte
// aligned bases; thread 0 issues them), else by every thread's 4-byte
// cp.async. A staged row of a half is 128 bytes in TMA's 128-byte swizzle:
// its 16-byte group g sits at g ^ (row & 7), so the LR rows a warp reads at
// one depth fall on distinct banks. Past Q, T and D the rows read as zeros;
// a half wholly past D is skipped (the split route's padded steps add
// fmaf(0, 0, acc), which leaves the chain's value as it is).
template <int BQ, int BR>
__global__ void __launch_bounds__(BQ * BR / 16) topk_sim_select_scores(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap tmap,
    const float* __restrict__ queries, const float* __restrict__ table, int n_q, int n_t, int d,
    int stages, int tma, float* __restrict__ scores) {
  constexpr int NT = BQ * BR / 16;
  constexpr int QT = BQ / 4, RT = BR / 4;  // threads across the queries, the rows
  constexpr int LQ = QT < 4 ? QT : 4, LR = 32 / LQ;  // a warp's lanes across them
  constexpr int WR = RT / LR;                         // warps across the rows
  constexpr int ROWS = BQ + BR;  // a half's staged rows: the queries, then the table's
  constexpr int HALF = ROWS * BOX * sizeof(float);  // bytes
  constexpr int G = BOX / 4;                        // float4 depth groups a half
  static_assert(NT % 32 == 0 && RT % LR == 0 && QT % LQ == 0, "tile");
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t bar0 = smem_u32(smem);
  // [stages][2 halves][ROWS][BOX], 1024-byte aligned, as the swizzle's 8-row period needs
  unsigned char* ring = smem + BAR_BYTES + (1024 - (bar0 + BAR_BYTES) % 1024) % 1024;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.x * BR, q0 = blockIdx.y * BQ;
  const int nr = min(BR, n_t - r0), nq = min(BQ, n_q - q0);
  const int n_chunks = (d + DC - 1) / DC;

  auto issue = [&](int c, int s) {  // chunk c into stage s
    const int d0 = c * DC, nc = min(DC, d - d0);
    unsigned char* dst = ring + s * 2 * HALF;
    const uint32_t bar = bar0 + 8 * s;
    if (tma) {
      if (tid != 0) return;
      const int halves = nc > BOX ? 2 : 1;
      // order this block's earlier reads of the stage before the async refill
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_expect_tx(bar, halves * HALF);  // whole boxes, zeros included
      for (int h = 0; h < halves; ++h) {
        tma_load_2d(smem_u32(dst + h * HALF), &qmap, bar, d0 + h * BOX, q0);
        tma_load_2d(smem_u32(dst + h * HALF + BQ * BOX * sizeof(float)), &tmap, bar,
                    d0 + h * BOX, r0);
      }
    } else {
      for (int e = tid; e < ROWS * DC; e += NT) {
        const int i = e / DC, col = e % DC, cc = col % BOX;
        const bool is_q = i < BQ;
        const int ri = is_q ? i : i - BQ;
        const bool ok = (is_q ? ri < nq : ri < nr) && col < nc;
        const float* src = !ok ? queries
                           : is_q ? queries + static_cast<size_t>(q0 + ri) * d + d0 + col
                                  : table + static_cast<size_t>(r0 + ri) * d + d0 + col;
        copy4(smem_u32(dst + (col / BOX) * HALF + i * 128 +
                       ((((cc >> 2) ^ (i & 7)) << 4) | ((cc & 3) << 2))),
              src, ok ? 4 : 0);
      }
      copies_arrive(bar);
    }
  };

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(bar0 + 8 * s, tma ? 1 : NT);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  for (int c = 0; c < min(stages, n_chunks); ++c) issue(c, c);

  // byte offsets in a half of this thread's rows, swizzle included: depth
  // group g of a row is at offset ^ (g << 4)
  const int tr = (warp % WR) * LR + lane % LR;
  const int tq = (warp / WR) * LQ + lane / LR;
  int qoff[4], toff[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tq + QT * i, t = BQ + tr + RT * i;
    qoff[i] = r * 128 + ((r & 7) << 4);
    toff[i] = t * 128 + ((t & 7) << 4);
  }
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  int s = 0;
  uint32_t phase = 0;
  for (int c = 0; c < n_chunks; ++c) {
    mbar_wait(bar0 + 8 * s, phase);
    const int halves = d - c * DC > BOX ? 2 : 1;
    for (int h = 0; h < halves; ++h) {
      const unsigned char* st = ring + (s * 2 + h) * HALF;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float4 a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = *reinterpret_cast<const float4*>(st + (qoff[i] ^ (g << 4)));
          b[i] = *reinterpret_cast<const float4*>(st + (toff[i] ^ (g << 4)));
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {  // the chain: d = 4g, 4g + 1, 4g + 2, 4g + 3 in order
            float v = acc[i][j];
            v = fmaf(a[i].x, b[j].x, v);
            v = fmaf(a[i].y, b[j].y, v);
            v = fmaf(a[i].z, b[j].z, v);
            v = fmaf(a[i].w, b[j].w, v);
            acc[i][j] = v;
          }
      }
    }
    __syncthreads();  // every thread is done with stage s
    if (c + stages < n_chunks) issue(c + stages, s);
    if (++s == stages) {
      s = 0;
      phase ^= 1;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = q0 + tq + QT * i;
    if (q >= n_q) continue;
    float* out = scores + static_cast<size_t>(q) * n_t;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + tr + RT * j;
      if (r < n_t) out[r] = acc[i][j];
    }
  }
}

// Sort x[0..p) descending (p a power of two) with a bitonic network; every
// thread of the block calls it. x is in global memory: the barrier between
// steps orders it for the block.
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

// The exclusive prefix sum of v over the block's threads in thread order;
// `sums` holds WARPS ints. Every thread calls it.
template <int WARPS>
__device__ int block_exclusive_scan(int v, int* sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < WARPS ? sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, w, o);
      if (lane >= o) w += y;
    }
    if (lane < WARPS) sums[lane] = w;
  }
  __syncthreads();
  return (warp > 0 ? sums[warp - 1] : 0) + x - v;
}

// Pass 2: a cluster of CS blocks a query. Block r holds the 32-bit score
// keys of rows [r * per, (r + 1) * per) of the query's scores, the first
// `cap` in shared memory (read once), the rest read again from the scratch.
// Four 8-bit radix passes over the score bits find the k-th largest score:
// each block counts its keys that match the prefix found so far (each thread
// adds a run of keys in one bin by one shared atomic), the blocks add the
// cluster's
// histograms in distributed shared memory, and warp 0 finds the bin by a
// suffix scan. Every key above the threshold score goes in; of the
// keys equal to it, the `remaining` lowest rows, counted in row order
// across the cluster (thread order within a block, rank order across
// blocks). The k survivors, as pack_key's 64-bit keys, go to the leader
// (rank 0): its shared memory for k <= SMEM_KEYS, ranked by counting the
// keys above each; else the [Q, p] scratch `sorted`, sorted by a bitonic
// network.
template <int THREADS>
__global__ void __launch_bounds__(THREADS) topk_sim_select_topk(
    const float* __restrict__ scores, int n_t, int k, int p, int cap,
    uint64_t* __restrict__ sorted, float* __restrict__ out_scores, int64_t* __restrict__ out_idx) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  const bool in_smem = k <= SMEM_KEYS;
  uint64_t* held = reinterpret_cast<uint64_t*>(smem);  // [k] the leader's survivors
  unsigned* hist = reinterpret_cast<unsigned*>(smem + (in_smem ? sizeof(uint64_t) * k : 0));
  unsigned* tot = hist + PASSES * BINS;              // [BINS] the cluster's histogram
  constexpr int WARPS = THREADS / 32;
  constexpr int KPT = SMEM_KEYS / THREADS;  // keys a thread ranks past THREADS
  int* sums = reinterpret_cast<int*>(tot + BINS);  // [MAX_WARPS]
  int* misc = sums + MAX_WARPS;                    // bin, remaining, its count, slots taken
  uint32_t* keys = reinterpret_cast<uint32_t*>(misc + 4);  // [cap] the slice's score keys

  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const long long qi = blockIdx.x / cs;
  const float* row = scores + qi * n_t;
  const int per = (n_t + cs - 1) / cs;
  const int begin = min(rank * per, n_t);
  const int n = min(per, n_t - begin);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  auto key_at = [&](int i) {
    return i < cap ? keys[i] : score_key(row[begin + i]);
  };
  // a block's own shared memory directly, a peer's through the cluster
  auto at = [&](auto* p, int r) { return r == rank ? p : cluster.map_shared_rank(p, r); };
  auto sync_cluster = [&] {  // a cluster of one needs only the block's barrier
    if (cs == 1) __syncthreads();
    else cluster.sync();
  };

  for (int i = tid; i < min(n, cap); i += THREADS) keys[i] = score_key(row[begin + i]);
  for (int i = tid; i < PASSES * BINS; i += THREADS) hist[i] = 0;
  if (tid == 0) misc[3] = 0;
  if (!in_smem && rank == 0)  // pad the sort with the key 0, below every row's key
    for (long long i = k + tid; i < p; i += THREADS) sorted[qi * p + i] = 0ull;
  __syncthreads();

  uint32_t prefix = 0, mask = 0;
  int remaining = k;  // keys still wanted among those whose bits match `prefix`
  int match = 0;      // the cluster's keys that match `prefix`
  int last = 0;       // the last pass run
  for (int pass = 0; pass < PASSES; ++pass) {
    const int shift = 24 - 8 * pass;
    unsigned* h = hist + pass * BINS;
    // a thread counts a run of keys in one bin and adds it to the histogram
    // when the bin changes: in the first pass, where most scores share their
    // top byte, that is a few atomics a thread, not one a key. A thread takes
    // UNROLL keys an iteration, so their loads overlap.
    int run_bin = BINS;
    unsigned run = 0;
    for (int base = 0; base < n; base += UNROLL * THREADS) {
      int bin[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = base + u * THREADS + tid;
        bin[u] = BINS;  // no bin
        if (i < n) {
          const uint32_t key = key_at(i);
          if ((key & mask) == prefix) bin[u] = static_cast<int>((key >> shift) & 255u);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (bin[u] == BINS) continue;
        if (bin[u] == run_bin) {
          ++run;
        } else {
          if (run) atomicAdd(&h[run_bin], run);
          run_bin = bin[u];
          run = 1;
        }
      }
    }
    if (run) atomicAdd(&h[run_bin], run);
    sync_cluster();  // every block's histogram of this pass is complete
    for (int b = tid; b < BINS; b += THREADS) {  // the peers' counts, all loads in flight
      unsigned v[MAX_CS];
#pragma unroll
      for (int r = 0; r < MAX_CS; ++r) v[r] = r < cs ? at(h, r)[b] : 0u;
      unsigned s = 0;
#pragma unroll
      for (int r = 0; r < MAX_CS; ++r) s += v[r];
      tot[b] = s;
    }
    __syncthreads();
    if (warp == 0) {  // lane l holds bins 255 - 8l - j, j = 0..7: a suffix scan from the top
      unsigned c[8], sum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[j] = tot[255 - 8 * lane - j];
        sum += c[j];
      }
      unsigned incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned y = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += y;
      }
      const unsigned hit = __ballot_sync(FULL, incl >= static_cast<unsigned>(remaining));
      if (lane == __ffs(hit) - 1) {
        unsigned before = incl - sum;
        for (int j = 0; j < 8; ++j) {
          if (before + c[j] >= static_cast<unsigned>(remaining)) {
            misc[0] = 255 - 8 * lane - j;
            misc[1] = remaining - static_cast<int>(before);
            misc[2] = static_cast<int>(c[j]);
            break;
          }
          before += c[j];
        }
      }
    }
    __syncthreads();
    prefix |= static_cast<uint32_t>(misc[0]) << shift;
    mask |= 255u << shift;
    remaining = misc[1];
    match = misc[2];
    last = pass;
    if (remaining == match) break;  // every key of the bin goes in (cluster-uniform)
  }

  // gather: pack_key's keys of the survivors into the leader's buffer
  const bool order = remaining < match;  // only some keys of the bin go in
  uint64_t* out = in_smem ? at(held, 0) : sorted + qi * p;
  int* slots = at(misc + 3, 0);
  const uint32_t top = prefix | ~mask;  // the largest key of the bin
  for (int base = 0; base < n; base += THREADS) {  // keys above the bin (or all of it), any order
    const int i = base + tid;
    uint32_t key = 0;
    bool take = false;
    if (i < n) {
      key = key_at(i);
      take = order ? key > top : key >= prefix;
    }
    const unsigned ballot = __ballot_sync(FULL, take);
    if (ballot == 0) continue;  // warp-uniform
    int slot = 0;
    if (lane == 0) slot = atomicAdd(slots, __popc(ballot));
    slot = __shfl_sync(FULL, slot, 0) + __popc(ballot & ((1u << lane) - 1u));
    if (take)
      out[slot] = (static_cast<uint64_t>(key) << 32) |
                  static_cast<uint64_t>(0xFFFFFFFFu - static_cast<uint32_t>(begin + i));
  }
  if (order) {  // the `remaining` lowest rows of the bin, after the k - remaining above it
    const int bin = static_cast<int>((prefix >> (24 - 8 * last)) & 255u);
    int before = 0;  // the bin's keys in lower-ranked blocks: lower rows
    for (int r = 0; r < rank; ++r) before += at(hist + last * BINS, r)[bin];
    const int m = (n + THREADS - 1) / THREADS;  // thread t walks rows [t m, t m + m) of the slice
    const int lo = min(tid * m, n), hi = min(lo + m, n);
    int cnt = 0;
    for (int i = lo; i < hi; ++i) cnt += (key_at(i) & mask) == prefix;
    int r = before + block_exclusive_scan<WARPS>(cnt, sums);
    for (int i = lo; i < hi && r < remaining; ++i) {
      const uint32_t key = key_at(i);
      if ((key & mask) != prefix) continue;
      out[k - remaining + r] =
          (static_cast<uint64_t>(key) << 32) |
          static_cast<uint64_t>(0xFFFFFFFFu - static_cast<uint32_t>(begin + i));
      ++r;
    }
  }
  sync_cluster();  // every survivor is with the leader; no block reads a peer after this
  if (rank != 0) return;

  const size_t o = static_cast<size_t>(qi) * k;
  if (in_smem && k <= THREADS) {
    // a key's place is the count of keys above it (keys are distinct): S
    // adjacent threads (k S <= THREADS, S <= 32) count one key's, each over
    // every S-th key, and add their counts by shuffles
    int sh = 0;
    while (sh < 5 && (k << (sh + 1)) <= THREADS) ++sh;
    const int i = tid >> sh, part = tid & ((1 << sh) - 1);
    const uint64_t x = i < k ? held[i] : 0ull;
    int r = 0;
#pragma unroll 4
    for (int j = part; j < k; j += 1 << sh) r += held[j] > x;
    for (int m = (1 << sh) >> 1; m > 0; m >>= 1) r += __shfl_xor_sync(FULL, r, m);
    if (i < k && part == 0) {
      out_scores[o + r] = key_score(x);
      out_idx[o + r] = static_cast<int64_t>(key_row(x));
    }
  } else if (in_smem) {  // KPT keys a thread
    uint64_t x[KPT];
    int r[KPT];
#pragma unroll
    for (int m = 0; m < KPT; ++m) {
      const int i = tid + THREADS * m;
      x[m] = i < k ? held[i] : 0ull;
      r[m] = 0;
    }
#pragma unroll 2
    for (int j = 0; j < k; ++j) {
      const uint64_t y = held[j];
#pragma unroll
      for (int m = 0; m < KPT; ++m) r[m] += y > x[m];
    }
#pragma unroll
    for (int m = 0; m < KPT; ++m) {
      const int i = tid + THREADS * m;
      if (i < k) {
        out_scores[o + r[m]] = key_score(x[m]);
        out_idx[o + r[m]] = static_cast<int64_t>(key_row(x[m]));
      }
    }
  } else {
    uint64_t* x = sorted + qi * p;
    bitonic_sort_desc(x, p);
    for (int i = tid; i < k; i += THREADS) {
      out_scores[o + i] = key_score(x[i]);
      out_idx[o + i] = static_cast<int64_t>(key_row(x[i]));
    }
  }
}

template <int BQ, int BR>
int launch_scores(const void* queries, const void* table, int n_q, int n_t, int d, int stages,
                  int tma, void* scores, cudaStream_t stream) {
  cudaError_t err;
  static bool configured = false;  // raise the dynamic shared memory cap once
  if (!configured) {
    err = cudaFuncSetAttribute(topk_sim_select_scores<BQ, BR>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_OPT_IN);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  CUtensorMap qmap = {}, tmap = {};
  if (tma) {
    static const EncodeTiled encode = load_encode_tiled();
    if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
    err = make_map(encode, &qmap, queries, n_q, d, BQ);
    if (err == cudaSuccess) err = make_map(encode, &tmap, table, n_t, d, BR);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((n_t + BR - 1) / BR, (n_q + BQ - 1) / BQ);
  topk_sim_select_scores<BQ, BR><<<grid, BQ * BR / 16, scores_smem_bytes(BQ, BR, stages), stream>>>(
      qmap, tmap, static_cast<const float*>(queries), static_cast<const float*>(table), n_q, n_t,
      d, stages, tma, static_cast<float*>(scores));
  return static_cast<int>(cudaGetLastError());
}

template <int THREADS>
int launch_topk(int cs, int cap, const void* scores, int n_q, int n_t, int k, int p, void* sorted,
                void* out_scores, void* out_idx, cudaStream_t stream) {
  cudaError_t err;
  static bool configured = false;
  if (!configured) {
    err = cudaFuncSetAttribute(topk_sim_select_topk<THREADS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_OPT_IN);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(topk_sim_select_topk<THREADS>,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(cs * n_q, 1, 1);
  config.blockDim = dim3(THREADS, 1, 1);
  config.dynamicSmemBytes = topk_smem_bytes(k, cap);
  config.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cs;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  config.attrs = &attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, topk_sim_select_topk<THREADS>,
                           static_cast<const float*>(scores), n_t, k, p, cap,
                           static_cast<uint64_t*>(sorted), static_cast<float*>(out_scores),
                           static_cast<int64_t*>(out_idx));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
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

// The select route's pass 1: scores [n_q, n_t] float32 by the FMA chain, in
// blocks of bq queries x br rows (SEL_TILE below; topk_sim/kernel.py::select_plan
// picks them) with a ring of `stages` chunks. Bulk tensor copies where
// D % 4 == 0 and both bases are 16-byte aligned, else 4-byte cp.async.
// Returns a tensor map's encode error or the launch's (0 on success).
int topk_sim_select_scores_launch(int device, int bq, int br, int stages, const void* queries,
                                  const void* table, int n_q, int n_t, int d, void* scores,
                                  void* stream) {
  if (n_q < 1 || n_t < 1 || d < 1 || bq < 1 || (n_q + bq - 1) / bq > 65535 || stages < 1 ||
      stages > sel::MAX_STAGES ||
      sel::scores_smem_bytes(bq, br, stages) > static_cast<size_t>(SMEM_OPT_IN)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int tma = d % 4 == 0 && aligned(queries) && aligned(table);
  const auto s = static_cast<cudaStream_t>(stream);
#define SEL_TILE(Q, R)                                                                   \
  if (bq == Q && br == R)                                                                \
    return sel::launch_scores<Q, R>(queries, table, n_q, n_t, d, stages, tma, scores, s);
  SEL_TILE(64, 64) SEL_TILE(64, 32) SEL_TILE(32, 128) SEL_TILE(32, 64) SEL_TILE(32, 32)
  SEL_TILE(16, 128) SEL_TILE(16, 64) SEL_TILE(16, 32) SEL_TILE(8, 128) SEL_TILE(8, 64)
#undef SEL_TILE
  return static_cast<int>(cudaErrorInvalidValue);
}

// The select route's pass 2: clusters of cs blocks (1 to 16, a power of
// two) of `threads` (512 or 1024) a query over its n_t scores, each block
// holding up to `cap` of its slice's keys in shared memory; p is k rounded up to a power of two, `sorted` a
// [n_q, p] uint64 scratch read only when k > 4096 (any pointer otherwise).
int topk_sim_select_topk_launch(int device, int threads, int cs, int cap, const void* scores,
                                int n_q, int n_t, int k, int p, void* sorted, void* out_scores,
                                void* out_idx, void* stream) {
  if (n_q < 1 || k < 1 || k > n_t || p < k || (p & (p - 1)) != 0 || p > (1 << 30) || cs < 1 ||
      cs > sel::MAX_CS || (cs & (cs - 1)) != 0 || cap < 0 ||
      static_cast<long long>(n_q) * cs > 0x7FFFFFFFLL ||
      sel::topk_smem_bytes(k, cap) > static_cast<size_t>(SMEM_OPT_IN)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  if (threads == 512) return sel::launch_topk<512>(cs, cap, scores, n_q, n_t, k, p, sorted, out_scores, out_idx, s);
  if (threads == 1024) return sel::launch_topk<1024>(cs, cap, scores, n_q, n_t, k, p, sorted, out_scores, out_idx, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Both passes of the select route, as the wrapper runs them: pass 1 into
// `scores`, then pass 2 from it (one call from the host for the two
// launches). Returns the first error (0 on success).
int topk_sim_select_launch(int device, int bq, int br, int stages, int threads, int cs, int cap,
                           const void* queries, const void* table, int n_q, int n_t, int d, int k,
                           int p, void* scores, void* sorted, void* out_scores, void* out_idx,
                           void* stream) {
  const int err = topk_sim_select_scores_launch(device, bq, br, stages, queries, table, n_q, n_t,
                                                d, scores, stream);
  if (err != 0) return err;
  return topk_sim_select_topk_launch(device, threads, cs, cap, scores, n_q, n_t, k, p, sorted,
                                     out_scores, out_idx, stream);
}

const char* topk_sim_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
