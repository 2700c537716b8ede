// Fused cosine similarity + top-K over a tool table, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/topk_sim/kernel.py::topk_sim_pallas (body `_kernel`):
// scores q . t^T for [Q, D] queries against a [T, D] table and returns the
// k best (score, index) pairs per query, descending, ties to the lowest
// index as lax.top_k breaks them. The [Q, T] score matrix is never written
// to device memory.
//
// What bounds it on an H100 (SXM, 3.35 TB/s, 67 TFLOP/s float32 outside the
// tensor cores): at the serving shape of 100,000 tools x 384 dims the table
// is T*D*4 B = 153.6 MB, which takes ~46 us to read once; the float32 FMA
// work is 2*Q*T*D = ~4.9 GFLOP at Q = 64, ~73 us. Small batches are bound
// by reading the table, Q >= ~64 by FMA throughput. At the native 2,413
// tools (3.7 MB, resident in L2) the bound is ~1-2 us and what costs is
// latency: launches, the chain of loads a block waits on, and merging.
//
// Two routes; the wrapper (topk_sim/kernel.py::topk_route) picks one before
// launch from shape and alignment, and neither falls back to the other.
//
// "split", for large tables. The TPU grid walks the table axis in order on
// one core, carrying a running top-K in VMEM scratch; at serving batch sizes
// that is a single program, which on 132 SMs would leave 131 idle. So the
// work is cut in two passes:
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
// Both routes keep lists of 64-bit keys: the order-preserving bits of the
// score above (0xFFFFFFFF - row), so a larger key is a higher score or, on
// a tie, a lower row, and one integer compare gives lax.top_k's order. A
// merge keeps a threshold (the list's k-th key): only candidates above it
// are staged, and a staged batch is merged by rank counting.
//
// The empty-slot sentinel NEG_INF is an argument, passed from Python, so
// the port has one sentinel. Limits: k <= 128, D <= 1024, the split route's
// n_split*k <= 4096 (the wrapper checks them). Reaching the tensor cores
// (wgmma with a split TF32 scheme) is later work.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mbarrier.cuh"

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

const char* topk_sim_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
