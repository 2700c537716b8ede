// Rotary embedding of q and k and the heads-major layout of q, k and v, in
// one launch, for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package ropes q and k with jnp ops inside
// its jitted prefill, where XLA fuses them into the projections' epilogue.
// In the eager port the same work was about 37 launches a layer between the
// q/k/v projections and the flash call (models/layers.py): RoPE's float32
// chain on strided halves, twice, then a heads-major copy of each of q, k
// and v. This kernel does all of it in one pass and is what
// `models/layers.py::attn_block` calls on its kernel path.
//
// What it computes, for q [B, S, H, hd], k and v [B, S, Hkv, hd] (the last
// dimension contiguous, any other strides), positions [B, S] int64 and
// inv_freq [hd / 2] float32 (the caller's theta ** (-i / half), made by the
// same torch ops as the plain rope): qh [B*H, S, hd], kh and vh [B*Hkv, S, hd],
// contiguous, where q and k are rotated in halves,
//   ang = float(pos) * inv_freq[i],
//   out[i] = x[i] cos(ang) - x[i + half] sin(ang),
//   out[i + half] = x[i] sin(ang) + x[i + half] cos(ang),
// in float32 with every product and sum rounded on its own (no FMA
// contraction: `__fmul_rn`, `__fsub_rn`, `__fadd_rn`), as the plain version
// rounds each tensor op, accurate `sincosf` (no fast-math intrinsics), and one
// rounding to the output type at the store; v is copied.
//
// What bounds it on an H100 (SXM, 3.35 TB/s): bytes. Every element is read
// once and written once (4 bytes an element in bf16); a granite-3-8b layer's
// 2,048-token prefill moves 50 MB (25 MB read, 25 MB written), ~15 us. The
// angles cost arithmetic only: a thread computes the sines and cosines of its
// V frequencies once for one token and applies them to HG heads, so the
// sincosf work is 1/HG of one a value.
//
// Design. A thread owns V consecutive elements of a row's first half (16
// bytes: 8 bf16 or 4 float32) and the V they pair with in the second half,
// for one token and up to HG heads. The grid is (token chunks, head groups,
// batch): x runs over S x (half / V) threads, token-major, so a warp reads
// and writes whole rows; y over the groups of HG rotated heads (q's H then
// k's Hkv) and then the groups of HG v heads, which copy; z over the batch.
// A thread issues all its heads' loads before it uses any, so it waits on
// one load latency, not one a head. Every row must start on a 16-byte
// boundary and its half be whole 16-byte units (hd 64, 80 and 128 in bf16
// and float32 are); the caller checks and raises otherwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int HG = 4;  // heads a thread walks with one set of angles

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// V values of T, loaded and stored as one 16-byte unit
template <typename T, int V>
struct alignas(sizeof(T) * V) Chunk {
  T e[V];
};

// Strides in elements: [tensor][batch, sequence, head] for q, k, v, then
// positions' batch and sequence strides.
struct Args {
  const void* src[3];
  void* dst[3];
  long long st[3][3];
  const long long* pos;
  long long pos_sb, pos_ss;
  const float* inv_freq;
  int s_len, h, hkv, hd, per_row, rot_groups;
};

template <typename T, int V>
__global__ void __launch_bounds__(THREADS) rope_heads_kernel(const Args a) {
  const long long idx = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const int t = static_cast<int>(idx / a.per_row);
  if (t >= a.s_len) return;
  const int i0 = static_cast<int>(idx % a.per_row) * V;
  const int half = a.hd / 2;
  const int b = blockIdx.z;
  const bool rotate = static_cast<int>(blockIdx.y) < a.rot_groups;
  const int first = (rotate ? blockIdx.y : blockIdx.y - a.rot_groups) * HG;
  const int n_heads = rotate ? a.h + a.hkv : a.hkv;

  // the heads' rows: rotated heads are q's, then k's; the others v's
  const T* src[HG];
  T* dst[HG];
#pragma unroll
  for (int j = 0; j < HG; ++j) {
    const int hh = first + j;
    const int which = rotate ? (hh < a.h ? 0 : 1) : 2;
    const int head = which == 1 ? hh - a.h : hh;
    const int rows = which == 0 ? a.h : a.hkv;
    src[j] = static_cast<const T*>(a.src[which]) + b * a.st[which][0] + t * a.st[which][1]
             + head * a.st[which][2] + i0;
    dst[j] = static_cast<T*>(a.dst[which])
             + ((static_cast<long long>(b) * rows + head) * a.s_len + t) * a.hd + i0;
  }
  Chunk<T, V> x1[HG], x2[HG];
#pragma unroll
  for (int j = 0; j < HG; ++j) {
    if (first + j < n_heads) {
      x1[j] = *reinterpret_cast<const Chunk<T, V>*>(src[j]);
      x2[j] = *reinterpret_cast<const Chunk<T, V>*>(src[j] + half);
    }
  }
  if (!rotate) {
#pragma unroll
    for (int j = 0; j < HG; ++j) {
      if (first + j < n_heads) {
        *reinterpret_cast<Chunk<T, V>*>(dst[j]) = x1[j];
        *reinterpret_cast<Chunk<T, V>*>(dst[j] + half) = x2[j];
      }
    }
    return;
  }
  const float p = static_cast<float>(a.pos[b * a.pos_sb + t * a.pos_ss]);
  float c[V], s[V];
#pragma unroll
  for (int e = 0; e < V; ++e) sincosf(__fmul_rn(p, a.inv_freq[i0 + e]), &s[e], &c[e]);
#pragma unroll
  for (int j = 0; j < HG; ++j) {
    if (first + j >= n_heads) continue;
    Chunk<T, V> y1, y2;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float u = to_f32(x1[j].e[e]), w = to_f32(x2[j].e[e]);
      y1.e[e] = from_f32<T>(__fsub_rn(__fmul_rn(u, c[e]), __fmul_rn(w, s[e])));
      y2.e[e] = from_f32<T>(__fadd_rn(__fmul_rn(u, s[e]), __fmul_rn(w, c[e])));
    }
    *reinterpret_cast<Chunk<T, V>*>(dst[j]) = y1;
    *reinterpret_cast<Chunk<T, V>*>(dst[j] + half) = y2;
  }
}

template <typename T, int V>
int launch(const Args& a, int batch, cudaStream_t stream) {
  const long long threads = static_cast<long long>(a.s_len) * a.per_row;
  const dim3 grid(static_cast<unsigned>((threads + THREADS - 1) / THREADS),
                  a.rot_groups + (a.hkv + HG - 1) / HG, batch);
  rope_heads_kernel<T, V><<<grid, THREADS, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Pointers are device pointers on `device`, except `strides`, a host array of
// 11 element strides: q's, k's and v's (batch, sequence, head), then
// positions' (batch, sequence). dtype is q's, k's, v's and the outputs': 0
// float32, 1 bfloat16. Every row of q, k and v must start on a 16-byte
// boundary and hd / 2 be a whole number of 16-byte units. Launches one
// kernel and returns its cudaError_t (0 on success).
int rope_heads_launch(int device, int dtype, const void* q, const void* k, const void* v,
                      const long long* strides, const void* positions, const void* inv_freq,
                      int batch, int s_len, int h, int hkv, int hd, void* qh, void* kh,
                      void* vh, void* stream) {
  const int elems = dtype == 0 ? 4 : 8;  // values in 16 bytes
  if (batch < 1 || batch > 65535 || s_len < 1 || h < 1 || hkv < 1 || hd < 2 ||
      (hd / 2) % elems || dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a{};
  a.src[0] = q;
  a.src[1] = k;
  a.src[2] = v;
  a.dst[0] = qh;
  a.dst[1] = kh;
  a.dst[2] = vh;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) a.st[i][j] = strides[3 * i + j];
  a.pos = static_cast<const long long*>(positions);
  a.pos_sb = strides[9];
  a.pos_ss = strides[10];
  a.inv_freq = static_cast<const float*>(inv_freq);
  a.s_len = s_len;
  a.h = h;
  a.hkv = hkv;
  a.hd = hd;
  a.per_row = hd / 2 / elems;
  a.rot_groups = (h + hkv + HG - 1) / HG;
  const auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float, 4>(a, batch, s) : launch<__nv_bfloat16, 8>(a, batch, s);
}

const char* rope_heads_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
