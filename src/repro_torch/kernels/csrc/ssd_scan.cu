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
// x and y are 13 MB each in bf16 and the work is a few hundred float32
// MFLOP per layer, so reading x and writing y bound it at a few
// microseconds. The sequence is a chain, though: this kernel runs one block
// per (batch, head), 50 blocks on 132 SMs at batch 1, each walking its
// sequence in order; splitting the sequence across blocks (a second pass
// that carries chunk states, as the chunked algorithm allows) is later work.
//
// Design. The TPU grid walks chunks in order with the [P, N] state in VMEM
// scratch; here a loop inside the block does, with the state in shared
// memory. The chunked algorithm is exact for any chunk length, so the block
// takes the sequence in 64-row tiles (a chunk of 256 is four tiles with the
// state carried between them; the caller's chunk only fixes the padding
// contract S % chunk == 0). Per tile:
//   1. a_cum = inclusive cumsum of a dt over the tile (warp shuffles);
//   2. xd = x dt, and B, C into shared memory (zero beyond S, so a ragged
//      tail is dt = 0, an identity on the state);
//   3. M = (C B^T) o L, L[l][s] = exp(a_cum[l] - a_cum[s]) for s <= l, else 0;
//   4. y = M xd + exp(a_cum) o (C state^T), from the state entering the tile;
//   5. state = state exp(a_cum[last]) + xd^T (B o exp(a_cum[last] - a_cum)).
// Each of 256 threads owns a 4 x 4 patch of M and 4 rows x P/16 columns of
// y; B, C and the state rows are padded to N + 1 floats so threads reading
// different rows hit different banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TL = 64;        // sequence rows per tile
constexpr int THREADS = 256;  // 16 x 16
constexpr int MAX_P = 128;
constexpr int MAX_N = 128;
constexpr int PC = MAX_P / 16;  // column slots of y per thread
constexpr int MS = TL + 1;      // stride of M
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

size_t smem_floats(int p, int n) {
  const int ns = n + 1;
  return static_cast<size_t>(TL) * p + 2 * TL * ns + TL * MS + p * ns + 3 * TL;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    ssd_scan_fwd(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ a_log, const float* __restrict__ bm,
                 const float* __restrict__ cm, T* __restrict__ y, float* __restrict__ st_out,
                 int s_len, int h, int p, int g, int n) {
  extern __shared__ __align__(16) float smem[];
  const int ns = n + 1;
  float* xd = smem;            // [TL][p]  x * dt
  float* bs = xd + TL * p;     // [TL][ns]
  float* cs = bs + TL * ns;    // [TL][ns]
  float* mm = cs + TL * ns;    // [TL][MS] masked, decayed C B^T
  float* st = mm + TL * MS;    // [p][ns]  carried state
  float* acum = st + p * ns;   // [TL]     cumulative a dt within the tile
  float* seg = acum + TL;      // [TL]     exp(acum[TL-1] - acum[l])
  float* dts = seg + TL;       // [TL]

  const int row = blockIdx.x;  // b * h + head
  const int b = row / h, head = row % h;
  const int grp = head / (h / g);
  const float a = -expf(a_log[head]);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int npc = (p + 15) / 16;

  for (int idx = tid; idx < p * ns; idx += THREADS) st[idx] = 0.f;

  for (int t0 = 0; t0 < s_len; t0 += TL) {
    // 1. step sizes and the tile's cumulative log-decay
    if (tid < TL) {
      const int pos = t0 + tid;
      const float d = pos < s_len ? dt[(static_cast<size_t>(b) * s_len + pos) * h + head] : 0.f;
      dts[tid] = d;
      float c = a * d;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(FULL, c, off);
        if ((tid & 31) >= off) c += u;
      }
      acum[tid] = c;
    }
    __syncthreads();
    if (tid >= 32 && tid < TL) acum[tid] += acum[31];
    __syncthreads();
    const float total = acum[TL - 1];

    // 2. the tile's inputs
    if (tid < TL) seg[tid] = expf(total - acum[tid]);
    for (int idx = tid; idx < TL * p; idx += THREADS) {
      const int l = idx / p, pp = idx % p, pos = t0 + l;
      xd[idx] = pos < s_len
                    ? to_f32(x[((static_cast<size_t>(b) * s_len + pos) * h + head) * p + pp]) * dts[l]
                    : 0.f;
    }
    for (int idx = tid; idx < TL * n; idx += THREADS) {
      const int l = idx / n, nn = idx % n, pos = t0 + l;
      float bv = 0.f, cv = 0.f;
      if (pos < s_len) {
        const size_t off = ((static_cast<size_t>(b) * s_len + pos) * g + grp) * n + nn;
        bv = bm[off];
        cv = cm[off];
      }
      bs[l * ns + nn] = bv;
      cs[l * ns + nn] = cv;
    }
    __syncthreads();

    // 3. M = (C B^T) o L on and below the diagonal
    {
      float sc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
      for (int nn = 0; nn < n; ++nn) {
        float cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = cs[(ty + 16 * i) * ns + nn];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = bs[(tx + 16 * j) * ns + nn];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(cv[i], bv[j], sc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int l = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = tx + 16 * j;
          mm[l * MS + s] = s <= l ? sc[i][j] * expf(fminf(acum[l] - acum[s], 0.f)) : 0.f;
        }
      }
    }
    __syncthreads();

    // 4. y = exp(a_cum) o (C state^T) + M xd
    {
      float yv[4][PC];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jc = 0; jc < PC; ++jc) yv[i][jc] = 0.f;
      for (int nn = 0; nn < n; ++nn) {
        float cv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = cs[(ty + 16 * i) * ns + nn];
#pragma unroll
        for (int jc = 0; jc < PC; ++jc) {
          const int pp = tx + 16 * jc;
          if (jc < npc && pp < p) {
            const float sv = st[pp * ns + nn];
#pragma unroll
            for (int i = 0; i < 4; ++i) yv[i][jc] = fmaf(cv[i], sv, yv[i][jc]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = expf(acum[ty + 16 * i]);
#pragma unroll
        for (int jc = 0; jc < PC; ++jc) yv[i][jc] *= e;
      }
      for (int s = 0; s < TL; ++s) {
        float mv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) mv[i] = mm[(ty + 16 * i) * MS + s];
#pragma unroll
        for (int jc = 0; jc < PC; ++jc) {
          const int pp = tx + 16 * jc;
          if (jc < npc && pp < p) {
            const float xv = xd[s * p + pp];
#pragma unroll
            for (int i = 0; i < 4; ++i) yv[i][jc] = fmaf(mv[i], xv, yv[i][jc]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int pos = t0 + ty + 16 * i;
        if (pos >= s_len) continue;
        T* yrow = y + ((static_cast<size_t>(b) * s_len + pos) * h + head) * p;
#pragma unroll
        for (int jc = 0; jc < PC; ++jc) {
          const int pp = tx + 16 * jc;
          if (jc < npc && pp < p) yrow[pp] = from_f32<T>(yv[i][jc]);
        }
      }
    }
    __syncthreads();  // every read of the entering state is done

    // 5. state = state exp(a_cum[last]) + xd^T (B o seg)
    const float decay = expf(total);
    for (int idx = tid; idx < p * n; idx += THREADS) {
      const int pp = idx / n, nn = idx % n;
      float acc = 0.f;
      for (int l = 0; l < TL; ++l) acc = fmaf(xd[l * p + pp], bs[l * ns + nn] * seg[l], acc);
      st[pp * ns + nn] = st[pp * ns + nn] * decay + acc;
    }
    __syncthreads();
  }

  float* out = st_out + static_cast<size_t>(row) * p * n;
  for (int idx = tid; idx < p * n; idx += THREADS) out[idx] = st[(idx / n) * ns + idx % n];
}

template <typename T>
int launch(const void* x, const void* dt, const void* a_log, const void* bm, const void* cm,
           void* y, void* state, int batch, int s_len, int h, int p, int g, int n,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(p, n);
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_fwd<T><<<batch * h, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(a_log),
      static_cast<const float*>(bm), static_cast<const float*>(cm), static_cast<T*>(y),
      static_cast<float*>(state), s_len, h, p, g, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Pointers are device pointers on `device`; `stream` is a cudaStream_t.
// dtype is x's and y's: 0 float32, 1 bfloat16; dt, a_log, B, C and the
// state are float32. Returns the launch's cudaError_t (0 on success).
int ssd_scan_launch(int device, int dtype, const void* x, const void* dt, const void* a_log,
                    const void* bm, const void* cm, void* y, void* state, int batch, int s_len,
                    int h, int p, int g, int n, void* stream) {
  if (batch < 1 || s_len < 1 || h < 1 || g < 1 || h % g != 0 || p < 1 || p > MAX_P || n < 1 ||
      n > MAX_N) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, dt, a_log, bm, cm, y, state, batch, s_len, h, p, g, n, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, a_log, bm, cm, y, state, batch, s_len, h, p, g, n, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
