// Mamba-2 SSD chunk scan (arXiv:2405.21060) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/ssd_scan/kernel.py::ssd_scan_pallas (body `_kernel`):
// for x [B, S, H, P], dt [B, S, H], a_log [H] and B, C [B, S, G, N] (head h
// reads group h / (H / G)) it returns y [B, S, H, P] in x's type and the
// final state [B, H, P, N] in float32 of the recurrence
//   state_t = exp(a dt_t) state_{t-1} + dt_t x_t B_t^T,   y_t = state_t C_t,
// with a = -exp(a_log) and a zero initial state. Everything is float32
// inside, as the TPU kernel casts; y is rounded to x's type once.
//
// What bounds it on an H100 (SXM, 3.35 TB/s, 67 TFLOP/s float32 outside the
// tensor cores): at hymba-1.5b's prefill (B 1, S 2048, H 50, P 64, N 16)
// x and y are 13 MB each in bf16 and the recurrence's least work is
// 0.42 GFLOP, so reading x and writing y bound it at ~8 us. The sequence is
// a chain, though, and one block per (batch, head) walking it in order
// leaves most of the card idle (50 blocks on 132 SMs at batch 1).
//
// Design. The chunked algorithm is exact for any tile length, so the
// sequence is cut into TL = 64-row tiles (128-row tiles measured slower:
// their M is four times the work for twice the rows; the caller's chunk only
// fixes the padding contract S % chunk == 0) and the work runs in three
// launches, two of them over every (batch, head, tile):
//   1. ssd_scan_states, grid (B*H, tiles): a tile's a_cum (inclusive cumsum
//      of a dt), its total log-decay a_cum[last], and its contribution
//      xd^T (B o exp(a_cum[last] - a_cum)) to the state, [P, N] float32,
//      into scratch (xd = x dt);
//   2. ssd_scan_carry, one thread per (batch, head, state entry): walks the
//      tiles in order, state_in[c] = state_in[c-1] exp(total[c-1]) +
//      contrib[c-1], written over the scratch in place, and the final
//      state. Each tile decays by its own total: a cumulative sum over the
//      whole sequence would underflow exp;
//   3. ssd_scan_output, grid (B*H, tiles): M = (C B^T) o L with
//      L[l][s] = exp(min(a_cum[l] - a_cum[s], 0)) for s <= l, else 0, and
//      y = M xd + exp(a_cum) o (C state_in^T), rounded once to x's type.
// Phase 2 is not folded into phase 3: a tile's entering state depends on
// every earlier tile, so a fold re-reads O(tiles^2) states.
// x, B and C are read where and as they lie: x and B/C with their own
// batch and row strides (ssm_block passes column slices of one xBC tensor),
// in x's type (bf16 -> float32 is exact), 16 bytes a load where the rows
// allow it. dt is float32 with its own strides. Zero rows beyond S make a
// ragged tail an identity on the state. A block issues all its global loads
// (dt, x, B, C, the entering state) before it uses any, so it waits on one
// load latency, not one a value; phase 1 writes its [P, N] tile state with
// neighbouring threads on neighbouring entries. In phase 3 each of
// 256 threads owns a (TL/16) x (TL/16) block of M (blocks above the
// diagonal are skipped) and TL/16 rows x 4 (or 8, for P > 64) columns of y;
// C, B, M and the entering state sit transposed in shared memory, so each
// operand of a product step is one float4 load, and the M xd product stops
// at the diagonal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TL = 64;        // sequence rows per tile
constexpr int THREADS = 256;  // 16 x 16
constexpr int MAX_P = 128;
constexpr int MAX_N = 128;
constexpr int CS = TL + 4;    // row stride of the transposed C, B and M
constexpr int SMEM_OPT_IN = 227 * 1024;
constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// values of T in 16 bytes, and those 16 bytes as floats (bf16 -> float32 is
// a shift of the bits)
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int E = 4;
  __device__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int E = 8;
  __device__ static void unpack(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  }
};

// Where a (batch, head) row's inputs lie. Strides are in elements; within
// a row x is [H][P] and B, C are [G][N], both contiguous. x_vec / bc_vec:
// every row of x / of B and C starts on a 16-byte boundary and holds whole
// 16-byte units, so the kernels read them 16 bytes at a time.
struct Args {
  const void* x;
  long long x_sb, x_ss;
  const float* dt;
  long long dt_sb, dt_ss;
  const float* a_log;
  const void* bm;
  const void* cm;
  long long bc_sb, bc_ss;
  int s_len, h, p, g, n, n_tiles, x_vec, bc_vec;
};

// R loads a thread kept in flight together: fetch() issues them, drain()
// stores what they brought. An item is 16 bytes, or one value in .x.
template <int R>
struct Prefetch {
  uint4 v[R];
  template <typename Load>
  __device__ __forceinline__ void fetch(int base, int total, Load load) {
#pragma unroll
    for (int u = 0; u < R; ++u)
      if (base + u * THREADS < total) v[u] = load(base + u * THREADS);
  }
  template <typename Store>
  __device__ __forceinline__ void drain(int base, int total, Store store) const {
#pragma unroll
    for (int u = 0; u < R; ++u)
      if (base + u * THREADS < total) store(base + u * THREADS, v[u]);
  }
};

// the items after a thread's first R: batches of R, each fetched then drained
template <int R, typename Load, typename Store>
__device__ __forceinline__ void copy_rest(int total, Load load, Store store) {
  for (int base = threadIdx.x + R * THREADS; base < total; base += R * THREADS) {
    Prefetch<R> pf;
    pf.fetch(base, total, load);
    pf.drain(base, total, store);
  }
}

// Loads and stores of one tile's x, B or C rows: items are 16-byte units
// (vector path) or single values, row l of the tile, zero beyond S.
template <typename T>
struct TileRows {
  const T* base;    // row 0 of the tile, this head / group
  long long ss;     // row stride
  int per_row;      // items a row
  int rows;         // rows of the tile before S
  bool vec;
  __device__ TileRows(const T* m, long long sb, long long ss_, int b, int t0, long long col0,
                      int w, int s_len, bool v)
      : base(m + b * sb + t0 * ss_ + col0), ss(ss_),
        per_row(v ? w / Vec<T>::E : w), rows(min(TL, s_len - t0)), vec(v) {}
  __device__ int items() const { return TL * per_row; }
  __device__ uint4 load(int i) const {
    const int l = i / per_row, j = i - l * per_row;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (l < rows) {
      if (vec) {
        u = *reinterpret_cast<const uint4*>(base + l * ss + j * Vec<T>::E);
      } else {
        u.x = __float_as_uint(to_f32(base[l * ss + j]));
      }
    }
    return u;
  }
  // f(l, column, value) for each value of item i, loaded as u
  template <typename F>
  __device__ __forceinline__ void each(int i, const uint4& u, F f) const {
    const int l = i / per_row, j = i - l * per_row;
    if (vec) {
      float v[Vec<T>::E];
      Vec<T>::unpack(u, v);
#pragma unroll
      for (int e = 0; e < Vec<T>::E; ++e) f(l, j * Vec<T>::E + e, v[e]);
    } else {
      f(l, j, __uint_as_float(u.x));
    }
  }
};

// acum = the inclusive cumsum of a dt over the tile, from dt_v (thread l <
// TL holds dt of row t0 + l, 0 beyond S); dts = dt. Synchronises the block.
__device__ __forceinline__ void tile_decay(float dt_v, float coef, float* dts, float* acum,
                                           float* wsum) {
  const int tid = threadIdx.x;
  if (tid < TL) {
    dts[tid] = dt_v;
    float c = coef * dt_v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(FULL, c, off);
      if ((tid & 31) >= off) c += u;
    }
    acum[tid] = c;
    if ((tid & 31) == 31) wsum[tid >> 5] = c;
  }
  __syncthreads();
  if (tid < TL) {
    float add = 0.f;
    for (int w = 0; w < (tid >> 5); ++w) add += wsum[w];
    acum[tid] += add;
  }
  __syncthreads();
}

__device__ __forceinline__ float load_dt(const Args& a, int b, int head, int t0) {
  const int pos = t0 + threadIdx.x;
  return threadIdx.x < TL && pos < a.s_len ? a.dt[b * a.dt_sb + pos * a.dt_ss + head] : 0.f;
}

__host__ __device__ constexpr int round4(int v) { return (v + 3) & ~3; }

size_t states_smem_floats(int p, int n) {
  return static_cast<size_t>(TL) * round4(p) + static_cast<size_t>(TL) * n + 3 * TL + 8;
}

size_t output_smem_floats(int p, int n) {
  const size_t xs = round4(p);
  return TL * xs + 2 * n * CS + TL * CS + n * xs + 2 * TL + 8;
}

// Phase 1: one block per (batch * head, tile).
template <typename T>
__global__ void __launch_bounds__(THREADS)
    ssd_scan_states(Args a, float* __restrict__ contrib, float* __restrict__ totals) {
  extern __shared__ __align__(16) float smem[];
  const int p = a.p, n = a.n, xs = round4(p);
  float* xd = smem;          // [TL][xs] x * dt, zero in the padding columns
  float* bs = xd + TL * xs;  // [TL][n]  B o seg
  float* acum = bs + TL * n;
  float* dts = acum + TL;
  float* seg = dts + TL;     // exp(acum[TL-1] - acum[l])
  float* wsum = seg + TL;    // [8]
  const int row = blockIdx.x, tile = blockIdx.y;
  const int b = row / a.h, head = row % a.h, grp = head / (a.h / a.g);
  const int t0 = tile * TL, tid = threadIdx.x;

  // every load of the tile in flight before any is used
  const TileRows<T> xr(static_cast<const T*>(a.x), a.x_sb, a.x_ss, b, t0,
                       static_cast<long long>(head) * p, p, a.s_len, a.x_vec);
  const TileRows<T> br(static_cast<const T*>(a.bm), a.bc_sb, a.bc_ss, b, t0,
                       static_cast<long long>(grp) * n, n, a.s_len, a.bc_vec);
  const float dt_v = load_dt(a, b, head, t0);
  const auto xload = [&](int i) { return xr.load(i); };
  const auto bload = [&](int i) { return br.load(i); };
  Prefetch<4> px;
  Prefetch<1> pb;
  px.fetch(tid, xr.items(), xload);
  pb.fetch(tid, br.items(), bload);
  for (int i = tid; i < TL * (xs - p); i += THREADS) xd[(i / (xs - p)) * xs + p + i % (xs - p)] = 0.f;

  tile_decay(dt_v, -expf(a.a_log[head]), dts, acum, wsum);
  const float total = acum[TL - 1];
  if (tid < TL) seg[tid] = expf(total - acum[tid]);
  __syncthreads();
  const auto xstore = [&](int i, const uint4& u) {
    xr.each(i, u, [&](int l, int c, float v) { xd[l * xs + c] = v * dts[l]; });
  };
  const auto bstore = [&](int i, const uint4& u) {
    br.each(i, u, [&](int l, int c, float v) { bs[l * n + c] = v * seg[l]; });
  };
  px.drain(tid, xr.items(), xstore);
  pb.drain(tid, br.items(), bstore);
  copy_rest<4>(xr.items(), xload, xstore);
  copy_rest<1>(br.items(), bload, bstore);
  __syncthreads();

  // thread: 4 consecutive columns pp of one state column nn; neighbouring
  // threads take neighbouring nn, so the [P][N] stores coalesce
  float* out = contrib + (static_cast<size_t>(row) * a.n_tiles + tile) * p * n;
  const int groups = xs / 4;
  for (int o = tid; o < groups * n; o += THREADS) {
    const int p4 = 4 * (o / n), nn = o - (p4 / 4) * n;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
    for (int l = 0; l < TL; ++l) {
      const float4 xv = *reinterpret_cast<const float4*>(xd + l * xs + p4);
      const float bv = bs[l * n + nn];
      acc[0] = fmaf(xv.x, bv, acc[0]);
      acc[1] = fmaf(xv.y, bv, acc[1]);
      acc[2] = fmaf(xv.z, bv, acc[2]);
      acc[3] = fmaf(xv.w, bv, acc[3]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (p4 + e < p) out[(p4 + e) * n + nn] = acc[e];
  }
  if (tid == 0) totals[static_cast<size_t>(row) * a.n_tiles + tile] = total;
}

// Phase 2: thread e of row (batch * head) carries state entry e across the
// tiles; contrib[c] becomes the state entering tile c.
__global__ void __launch_bounds__(THREADS)
    ssd_scan_carry(float* __restrict__ contrib, const float* __restrict__ totals,
                   float* __restrict__ st_out, int pn, int n_tiles) {
  const int row = blockIdx.x;
  const int e = blockIdx.y * THREADS + threadIdx.x;
  if (e >= pn) return;
  float* c_row = contrib + static_cast<size_t>(row) * n_tiles * pn + e;
  const float* t_row = totals + static_cast<size_t>(row) * n_tiles;
  float carry = 0.f;
  for (int c0 = 0; c0 < n_tiles; c0 += 8) {
    float v[8], decay[8];  // loads of eight tiles in flight at once
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (c0 + i < n_tiles) {
        v[i] = c_row[static_cast<size_t>(c0 + i) * pn];
        decay[i] = expf(t_row[c0 + i]);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (c0 + i < n_tiles) {
        c_row[static_cast<size_t>(c0 + i) * pn] = carry;
        carry = carry * decay[i] + v[i];
      }
    }
  }
  st_out[static_cast<size_t>(row) * pn + e] = carry;
}

// four values of y at a 4-value boundary (8 bytes of bf16, 16 of float32)
__device__ __forceinline__ void store4(float* dst, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(dst) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, float a, float b, float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = u;
}

__device__ __forceinline__ void load4(float (&dst)[4], const float* src) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}

// Phase 3: one block per (batch * head, tile). Thread (ty, tx) of 16 x 16
// owns rows 4ty .. 4ty+3 of y, columns 4tx .. 4tx+3 (and 64 + those when
// NCG = 2, for P > 64), and the 4 x 4 block (ty, tx) of M. C, B, M and the
// state sit transposed in shared memory, so every operand is one float4.
template <typename T, int NCG>
__global__ void __launch_bounds__(THREADS)
    ssd_scan_output(Args a, const float* __restrict__ state_in, T* __restrict__ y) {
  extern __shared__ __align__(16) float smem[];
  const int p = a.p, n = a.n, xs = round4(p);
  float* xd = smem;            // [TL][xs]
  float* ct = xd + TL * xs;    // [n][CS]  C^T
  float* bt = ct + n * CS;     // [n][CS]  B^T
  float* mt = bt + n * CS;     // [TL][CS] M^T: mt[s][l] = M[l][s]
  float* stt = mt + TL * CS;   // [n][xs]  state entering the tile, transposed
  float* acum = stt + n * xs;  // [TL]
  float* dts = acum + TL;      // [TL]
  float* wsum = dts + TL;      // [8]
  const int row = blockIdx.x, tile = blockIdx.y;
  const int b = row / a.h, head = row % a.h, grp = head / (a.h / a.g);
  const int t0 = tile * TL;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  // every load of the tile in flight before any is used
  const TileRows<T> xr(static_cast<const T*>(a.x), a.x_sb, a.x_ss, b, t0,
                       static_cast<long long>(head) * p, p, a.s_len, a.x_vec);
  const TileRows<T> br(static_cast<const T*>(a.bm), a.bc_sb, a.bc_ss, b, t0,
                       static_cast<long long>(grp) * n, n, a.s_len, a.bc_vec);
  const TileRows<T> cr(static_cast<const T*>(a.cm), a.bc_sb, a.bc_ss, b, t0,
                       static_cast<long long>(grp) * n, n, a.s_len, a.bc_vec);
  const float* sin = state_in + (static_cast<size_t>(row) * a.n_tiles + tile) * p * n;
  const bool svec = (p * n) % 4 == 0;
  const int s_items = svec ? p * n / 4 : p * n;
  const float dt_v = load_dt(a, b, head, t0);
  const auto xload = [&](int i) { return xr.load(i); };
  const auto bload = [&](int i) { return br.load(i); };
  const auto cload = [&](int i) { return cr.load(i); };
  const auto sload = [&](int i) {
    if (svec) return *reinterpret_cast<const uint4*>(sin + 4 * i);
    return make_uint4(__float_as_uint(sin[i]), 0, 0, 0);
  };
  Prefetch<4> px;
  Prefetch<1> pb, pc, ps;
  px.fetch(tid, xr.items(), xload);
  pb.fetch(tid, br.items(), bload);
  pc.fetch(tid, cr.items(), cload);
  ps.fetch(tid, s_items, sload);
  for (int i = tid; i < TL * (xs - p); i += THREADS) xd[(i / (xs - p)) * xs + p + i % (xs - p)] = 0.f;
  for (int i = tid; i < n * (xs - p); i += THREADS) stt[(i / (xs - p)) * xs + p + i % (xs - p)] = 0.f;

  tile_decay(dt_v, -expf(a.a_log[head]), dts, acum, wsum);
  const auto xstore = [&](int i, const uint4& u) {
    xr.each(i, u, [&](int l, int c, float v) { xd[l * xs + c] = v * dts[l]; });
  };
  const auto bstore = [&](int i, const uint4& u) {  // transposed
    br.each(i, u, [&](int l, int c, float v) { bt[c * CS + l] = v; });
  };
  const auto cstore = [&](int i, const uint4& u) {
    cr.each(i, u, [&](int l, int c, float v) { ct[c * CS + l] = v; });
  };
  const auto sstore = [&](int i, const uint4& u) {  // [p][n] -> stt[n][xs]
    const auto put = [&](int k, uint32_t w) {
      const int pp = k / n;
      stt[(k - pp * n) * xs + pp] = __uint_as_float(w);
    };
    if (svec) {
      put(4 * i, u.x);
      put(4 * i + 1, u.y);
      put(4 * i + 2, u.z);
      put(4 * i + 3, u.w);
    } else {
      put(i, u.x);
    }
  };
  px.drain(tid, xr.items(), xstore);
  pb.drain(tid, br.items(), bstore);
  pc.drain(tid, cr.items(), cstore);
  ps.drain(tid, s_items, sstore);
  copy_rest<4>(xr.items(), xload, xstore);
  copy_rest<1>(br.items(), bload, bstore);
  copy_rest<1>(cr.items(), cload, cstore);
  copy_rest<1>(s_items, sload, sstore);
  __syncthreads();

  // M = (C B^T) o L, L[l][s] = exp(min(a_cum[l] - a_cum[s], 0)) for s <= l;
  // blocks above the diagonal are never read
  const int r0 = 4 * ty;
  if (tx <= ty) {
    const int s0 = 4 * tx;
    float m[4][4] = {};
    for (int nn = 0; nn < n; ++nn) {
      float cv[4], bv[4];
      load4(cv, ct + nn * CS + r0);
      load4(bv, bt + nn * CS + s0);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) m[i][j] = fmaf(cv[i], bv[j], m[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = s0 + j;
      float4 v;
      float* e = &v.x;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int l = r0 + i;
        e[i] = s <= l ? m[i][j] * expf(fminf(acum[l] - acum[s], 0.f)) : 0.f;
      }
      *reinterpret_cast<float4*>(mt + s * CS + r0) = v;
    }
  }
  __syncthreads();

  // y = exp(a_cum) o (C state^T) + M xd, columns 4tx (+ 64)
  constexpr int NC = 4 * NCG;
  const bool col1 = NCG == 2 && 4 * tx + 64 < xs;
  float yv[4][NC] = {};
  for (int nn = 0; nn < n; ++nn) {
    float cv[4], sv[NC];
    load4(cv, ct + nn * CS + r0);
    const float* srow = stt + nn * xs + 4 * tx;
#pragma unroll
    for (int g = 0; g < NCG; ++g) {
      const float4 v = g == 0 || col1 ? *reinterpret_cast<const float4*>(srow + 64 * g)
                                      : make_float4(0.f, 0.f, 0.f, 0.f);
      sv[4 * g] = v.x; sv[4 * g + 1] = v.y; sv[4 * g + 2] = v.z; sv[4 * g + 3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) yv[i][j] = fmaf(cv[i], sv[j], yv[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float e = expf(acum[r0 + i]);
#pragma unroll
    for (int j = 0; j < NC; ++j) yv[i][j] *= e;
  }
  for (int s = 0; s < r0 + 4; ++s) {  // M[l][s] = 0 for s > l
    float mv[4], xv[NC];
    load4(mv, mt + s * CS + r0);
    const float* xrow = xd + s * xs + 4 * tx;
#pragma unroll
    for (int g = 0; g < NCG; ++g) {
      const float4 v = g == 0 || col1 ? *reinterpret_cast<const float4*>(xrow + 64 * g)
                                      : make_float4(0.f, 0.f, 0.f, 0.f);
      xv[4 * g] = v.x; xv[4 * g + 1] = v.y; xv[4 * g + 2] = v.z; xv[4 * g + 3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) yv[i][j] = fmaf(mv[i], xv[j], yv[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int pos = t0 + r0 + i;
    if (pos >= a.s_len) continue;
    T* yrow = y + ((static_cast<size_t>(b) * a.s_len + pos) * a.h + head) * p;
#pragma unroll
    for (int g = 0; g < NCG; ++g) {
      const int pp = 4 * tx + 64 * g;
      if (xs == p && pp < p) {  // four columns in one store
        store4(yrow + pp, yv[i][4 * g], yv[i][4 * g + 1], yv[i][4 * g + 2], yv[i][4 * g + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (pp + e < p) yrow[pp + e] = from_f32<T>(yv[i][4 * g + e]);
      }
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem > static_cast<size_t>(SMEM_OPT_IN)) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T>
int launch_states(const Args& a, int rows, void* contrib, void* totals, cudaStream_t stream) {
  const size_t smem = sizeof(float) * states_smem_floats(a.p, a.n);
  const cudaError_t err = allow_smem(ssd_scan_states<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_states<T><<<dim3(rows, a.n_tiles), THREADS, smem, stream>>>(
      a, static_cast<float*>(contrib), static_cast<float*>(totals));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NCG>
int launch_output(const Args& a, int rows, const void* state_in, void* y, cudaStream_t stream) {
  const size_t smem = sizeof(float) * output_smem_floats(a.p, a.n);
  const cudaError_t err = allow_smem(ssd_scan_output<T, NCG>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_output<T, NCG><<<dim3(rows, a.n_tiles), THREADS, smem, stream>>>(
      a, static_cast<const float*>(state_in), static_cast<T*>(y));
  return static_cast<int>(cudaGetLastError());
}

int check_args(int batch, int s_len, int h, int p, int g, int n, int n_tiles) {
  if (batch < 1 || s_len < 1 || h < 1 || g < 1 || h % g != 0 || p < 1 || p > MAX_P || n < 1 ||
      n > MAX_N || n_tiles != (s_len + TL - 1) / TL || n_tiles > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

Args make_args(const void* x, long long x_sb, long long x_ss, const void* dt, long long dt_sb,
               long long dt_ss, const void* a_log, const void* bm, const void* cm,
               long long bc_sb, long long bc_ss, int s_len, int h, int p, int g, int n,
               int n_tiles, int x_vec, int bc_vec) {
  return Args{x, x_sb, x_ss, static_cast<const float*>(dt), dt_sb, dt_ss,
              static_cast<const float*>(a_log), bm, cm, bc_sb, bc_ss, s_len, h, p, g, n,
              n_tiles, x_vec, bc_vec};
}

}  // namespace

extern "C" {

// Pointers are device pointers on `device`; `stream` is a cudaStream_t.
// dtype is x's, y's, B's and C's: 0 float32, 1 bfloat16. dt and a_log are
// float32. Strides are in elements: x [b, s] (then H x P contiguous), dt
// [b, s] (then H), B and C [b, s] (then G x N). x_vec / bc_vec say that the
// rows of x / of B and C start on 16-byte boundaries and hold whole 16-byte
// units. n_tiles = ceil(s_len / 64). contrib is float32 [batch * h,
// n_tiles, p, n], totals float32 [batch * h, n_tiles]. Each function
// launches one kernel and returns its cudaError_t (0 on success).

// Phase 1: each tile's contribution to the state, and its total log-decay.
int ssd_scan_states_launch(int device, int dtype, const void* x, long long x_sb, long long x_ss,
                           const void* dt, long long dt_sb, long long dt_ss, const void* a_log,
                           const void* bm, const void* cm, long long bc_sb, long long bc_ss,
                           int batch, int s_len, int h, int p, int g, int n, int n_tiles,
                           int x_vec, int bc_vec, void* contrib, void* totals, void* stream) {
  const int rc = check_args(batch, s_len, h, p, g, n, n_tiles);
  if (rc != 0 || dtype < 0 || dtype > 1) return rc ? rc : static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a = make_args(x, x_sb, x_ss, dt, dt_sb, dt_ss, a_log, bm, cm, bc_sb, bc_ss, s_len, h,
                           p, g, n, n_tiles, x_vec, bc_vec);
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_states<float>(a, batch * h, contrib, totals, s);
  return launch_states<__nv_bfloat16>(a, batch * h, contrib, totals, s);
}

// Phase 2: contrib becomes each tile's entering state, in place; the final
// state, float32 [batch * h, p, n], goes to st_out.
int ssd_scan_carry_launch(int device, void* contrib, const void* totals, void* st_out, int rows,
                          int pn, int n_tiles, void* stream) {
  if (rows < 1 || pn < 1 || n_tiles < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_carry<<<dim3(rows, (pn + THREADS - 1) / THREADS), THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(static_cast<float*>(contrib),
                                                        static_cast<const float*>(totals),
                                                        static_cast<float*>(st_out), pn,
                                                        n_tiles);
  return static_cast<int>(cudaGetLastError());
}

// Phase 3: y, contiguous [batch, s_len, h, p] in x's type, from the
// entering states that phase 2 left in contrib.
int ssd_scan_output_launch(int device, int dtype, const void* x, long long x_sb, long long x_ss,
                           const void* dt, long long dt_sb, long long dt_ss, const void* a_log,
                           const void* bm, const void* cm, long long bc_sb, long long bc_ss,
                           int batch, int s_len, int h, int p, int g, int n, int n_tiles,
                           int x_vec, int bc_vec, const void* state_in, void* y, void* stream) {
  const int rc = check_args(batch, s_len, h, p, g, n, n_tiles);
  if (rc != 0 || dtype < 0 || dtype > 1) return rc ? rc : static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a = make_args(x, x_sb, x_ss, dt, dt_sb, dt_ss, a_log, bm, cm, bc_sb, bc_ss, s_len, h,
                           p, g, n, n_tiles, x_vec, bc_vec);
  const auto s = static_cast<cudaStream_t>(stream);
  const int rows = batch * h;
  const bool wide = round4(p) > 64;
  if (dtype == 0)
    return wide ? launch_output<float, 2>(a, rows, state_in, y, s)
                : launch_output<float, 1>(a, rows, state_in, y, s);
  return wide ? launch_output<__nv_bfloat16, 2>(a, rows, state_in, y, s)
              : launch_output<__nv_bfloat16, 1>(a, rows, state_in, y, s);
}

// Dynamic shared memory, in bytes, of phase 1 (phase = 1) or phase 3 at P
// and N (each must be within the 227 KB a block may opt into).
long long ssd_scan_smem_bytes(int phase, int p, int n) {
  const size_t floats = phase == 1 ? states_smem_floats(p, n) : output_smem_floats(p, n);
  return static_cast<long long>(sizeof(float) * floats);
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
