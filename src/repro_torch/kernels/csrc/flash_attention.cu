// Flash attention (online softmax, causal + sliding window) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas (body
// `_kernel`): out = softmax(q k^T / sqrt(hd) + mask) v for q [BH, Sq, hd] and
// k, v [BHkv, Skv, hd], where query row bh reads key/value row bh / groups
// (groups = BH / BHkv: grouped-query attention without repeating k and v).
// The mask keeps key position j for query position i = q_offset + row when
// j < Skv, and j <= i if causal, and j > i - window if window > 0. The
// running max, denominator and accumulator are float32; p is rounded to v's
// type before the PV product and the output is written in q's type, as the
// TPU kernel casts. The [Sq, Skv] score matrix never reaches device memory.
//
// What bounds it on an H100 (SXM, 3.35 TB/s; 989 TFLOP/s bf16 on the tensor
// cores, 67 TFLOP/s float32 outside them): at hymba-1.5b's prefill (25
// q-heads, 5 kv-heads, S = 2048, hd 64, window 1024) the live q-k pairs need
// 4*hd*pairs = ~10 GFLOP per layer, while q, k, v and the output are ~16 MB
// in bf16: the work, not the bytes, bounds it. This first kernel multiplies
// with float32 FMAs on the CUDA cores for both input types (so float32 runs
// in full float32, never TF32), which puts it far above the tensor-core
// bound in bf16; wgmma with TMA-fed tiles is later work.
//
// Design. One block of 256 threads per (64 query rows, head). The block
// keeps its q tile in shared memory and streams 64-row k/v tiles through it,
// but only the tiles that hold a live key: the loop starts at the first key
// inside the window of the block's first row and stops after the last key
// its last row may see, so fully masked tiles (the future under causality,
// the expired past under a window) are never loaded. Each thread owns a
// 4 x 4 patch of the 64 x 64 score tile and 4 rows x (hd/16) columns of the
// output; q and k are stored transposed (d-major) so a thread reads its
// four rows and its four keys as one 16-byte load each. Row maxima and sums
// are reduced across the 16 threads of a row with warp shuffles. The
// probabilities go through shared memory, transposed, to the PV product.
// Masked scores contribute exactly zero (a row with no live key yet keeps
// its sum at zero), and the output is acc / max(l, 1e-30) as on the TPU.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 x 16: thread (ty, tx) owns rows ty*4.., keys tx*4..
constexpr int SP = BQ + 4;    // stride of the transposed tiles (rows stay 16-byte aligned)
constexpr float NEG = -1e30f;
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

template <typename T, int HDP>
__global__ void __launch_bounds__(THREADS)
    flash_attention_fwd(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o, int sq, int skv, int hd,
                        int groups, int causal, int window, int q_offset, float scale) {
  constexpr int NC = HDP / 64;  // output column groups of 64 (4 columns each per thread)
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;           // [HDP][SP] q tile, transposed
  float* kt = qt + HDP * SP;  // [HDP][SP] k tile, transposed
  float* vs = kt + HDP * SP;  // [BK][HDP] v tile
  float* pt = vs + BK * HDP;  // [BK][SP]  probabilities, transposed

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const T* qb = q + static_cast<size_t>(bh) * sq * hd;
  const T* kb = k + static_cast<size_t>(bh / groups) * skv * hd;
  const T* vb = v + static_cast<size_t>(bh / groups) * skv * hd;
  T* ob = o + static_cast<size_t>(bh) * sq * hd;

  for (int idx = tid; idx < BQ * HDP; idx += THREADS) {
    const int d = idx % HDP, r = idx / HDP;
    float val = 0.f;
    if (q0 + r < sq && d < hd) val = to_f32(qb[static_cast<size_t>(q0 + r) * hd + d]);
    qt[d * SP + r] = val;
  }

  // the keys any row of this block may see: [k_begin, k_end)
  const int q_last = min(q0 + BQ, sq) - 1;
  int k_end = skv;
  if (causal) k_end = min(k_end, q_offset + q_last + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q_offset + q0 - window + 1);
  k_begin = (k_begin / BK) * BK;

  int qpos[4];
  float m[4], l[4], acc[4][4 * NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    qpos[i] = q_offset + q0 + ty * 4 + i;
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's PV product is done with vs and pt
    for (int idx = tid; idx < BK * HDP; idx += THREADS) {
      const int d = idx % HDP, c = idx / HDP;
      float kv = 0.f, vv = 0.f;
      if (k0 + c < skv && d < hd) {
        const size_t off = static_cast<size_t>(k0 + c) * hd + d;
        kv = to_f32(kb[off]);
        vv = to_f32(vb[off]);
      }
      kt[d * SP + c] = kv;
      vs[c * HDP + d] = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&qt[d * SP + ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&kt[d * SP + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool live[4];
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx * 4 + j;
        bool ok = kp < skv;
        if (causal) ok = ok && kp <= qpos[i];
        if (window > 0) ok = ok && kp > qpos[i] - window;
        live[j] = ok;
        s[i][j] = ok ? s[i][j] * scale : NEG;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = live[j] ? expf(s[i][j] - m_new) : 0.f;
        rs += p[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(FULL, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * NC; ++c) acc[i][c] *= alpha;
    }
    // p in v's type for the PV product (the sum l above keeps float32 p)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float4 w;
      w.x = to_f32(from_f32<T>(p[0][j]));
      w.y = to_f32(from_f32<T>(p[1][j]));
      w.z = to_f32(from_f32<T>(p[2][j]));
      w.w = to_f32(from_f32<T>(p[3][j]));
      *reinterpret_cast<float4*>(&pt[(tx * 4 + j) * SP + ty * 4]) = w;
    }
    __syncthreads();

    for (int c = 0; c < BK; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(&pt[c * SP + ty * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int g = 0; g < NC; ++g) {
        const float4 b = *reinterpret_cast<const float4*>(&vs[c * HDP + g * 64 + tx * 4]);
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) acc[i][g * 4 + jj] = fmaf(av[i], bv[jj], acc[i][g * 4 + jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < NC; ++g)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int d = g * 64 + tx * 4 + jj;
        if (d < hd) ob[static_cast<size_t>(r) * hd + d] = from_f32<T>(acc[i][g * 4 + jj] / denom);
      }
  }
}

template <typename T, int HDP>
int launch(const void* q, const void* k, const void* v, void* o, int bh, int groups, int sq,
           int skv, int hd, int causal, int window, int q_offset, float scale,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * HDP * SP + BK * HDP + BK * SP);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_fwd<T, HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + BQ - 1) / BQ, bh);
  flash_attention_fwd<T, HDP><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), sq, skv, hd, groups, causal, window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* o, int bh, int groups, int sq,
              int skv, int hd, int causal, int window, int q_offset, float scale,
              cudaStream_t stream) {
  if (hd <= 64)
    return launch<T, 64>(q, k, v, o, bh, groups, sq, skv, hd, causal, window, q_offset, scale,
                         stream);
  return launch<T, 128>(q, k, v, o, bh, groups, sq, skv, hd, causal, window, q_offset, scale,
                        stream);
}

}  // namespace

extern "C" {

// Pointers are device pointers on `device`; `stream` is a cudaStream_t.
// dtype: 0 float32, 1 bfloat16 (q, k, v and o share it). Returns the
// launch's cudaError_t (0 on success).
int flash_attention_launch(int device, int dtype, const void* q, const void* k, const void* v,
                           void* o, int bh, int groups, int sq, int skv, int hd, int causal,
                           int window, int q_offset, float scale, void* stream) {
  if (hd < 1 || hd > 128 || bh < 1 || bh > 65535 || groups < 1 || bh % groups != 0 ||
      sq < 1 || skv < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_hd<float>(q, k, v, o, bh, groups, sq, skv, hd, causal, window, q_offset,
                            scale, s);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(q, k, v, o, bh, groups, sq, skv, hd, causal, window,
                                    q_offset, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
