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
// by reading the table, Q >= ~64 by FMA throughput.
//
// Design. The TPU grid walks the table axis in order on one core, carrying
// a running top-K in VMEM scratch; at serving batch sizes (Q <= 128) that
// is a single program, which on 132 SMs would leave 131 idle. So the work
// is cut in two passes:
//   pass 1, topk_sim_partial: grid (n_split, ceil(Q/QB)), about four blocks
//     per SM. A block streams its slice of the table in [TB, DK] chunks
//     (the next chunk's loads are in flight while the current one is
//     multiplied), computes each score with a float32 FMA chain over
//     d = 0..D-1 (no TF32: TF32 flips top-K indices), and after each tile
//     merges the tile's scores into a sorted top-k list per query in shared
//     memory. QB is 8 for batches of up to 8 queries, else 32, so a small
//     batch does not pay for 32 query slots. It writes the lists to a
//     [Q, n_split, k] scratch.
//   pass 2, topk_sim_merge: one block per query copies its n_split sorted
//     lists into shared memory and merges them with the same routine.
// A merge keeps a threshold (the list's k-th key): only candidates above it
// are staged, and a staged batch is merged by rank counting, so no
// candidate is inserted one at a time. Candidates are compared as 64-bit
// keys: the order-preserving bits of the score above (0xFFFFFFFF - row). A
// larger key is a higher score or, on a tie, a lower row, so one integer
// compare gives lax.top_k's order. No atomics: the result is deterministic.
//
// The empty-slot sentinel NEG_INF is an argument, passed from Python, so
// the port has one sentinel. Limits: k <= 128, D <= 1024, n_split*k <= 4096
// (the wrapper checks them). Reaching the tensor cores (wgmma with a split
// TF32 scheme) and feeding the table through TMA are later work.

#include <cuda_runtime.h>

#include <cstdint>

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

const char* topk_sim_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
