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
// type before the PV product (the denominator sums the float32 p) and the
// output, acc / max(l, 1e-30), is written in q's type, as the TPU kernel
// casts. The [Sq, Skv] score matrix never reaches device memory.
//
// Two kernels; the wrapper (`kernels/flash_attention/kernel.py::flash_route`)
// picks one by type and shape, and neither falls back to the other:
//
//   wgmma — bf16 with hd % 8 == 0, hd <= 128 and 16-byte aligned bases:
//           bf16 x bf16 products into float32 on the tensor cores, as the
//           TPU kernel multiplies on its MXU. Bound, at hymba-1.5b's prefill
//           (25 q-heads over 5 kv-heads, S 2,048, hd 64, window 1,024), by
//           the work: 4*hd FLOPs per live pair, ~10 GFLOP a layer, ~10 us at
//           989 TFLOP/s, against ~16 MB of q, k, v and output (~5 us).
//   fma   — float32 (in full float32, never TF32: the float32 parity tests
//           hold it to 2e-5) and bf16 the wgmma kernel cannot take (hd not a
//           multiple of 8: a TMA row stride must be a multiple of 16 bytes).
//           float32 FMAs on the CUDA cores, bound by their 67 TFLOP/s.
//
// wgmma design. One block of 288 threads per (128 query rows, q-head): two
// consumer warpgroups of 64 rows each and one producer warp. The producer
// loads the q tile once with TMA, then keeps a 2-stage ring of 128-key k and
// v tiles in flight (mbarriers: `full` counts the TMA bytes, `empty` the 256
// consumer threads), loading only the tiles between the first key inside
// the window of the block's first row and the last key its last row may
// see. Tiles sit in shared memory in TMA's 128-byte swizzle, 1024-byte
// aligned: q 16/32 KB, each stage's k and v 16/32 KB (hd 64/128), ~160 KB at
// hd 128. Per tile each consumer warpgroup computes S = Q K^T with
// wgmma.m64n128k16 (both operands in shared memory, K-major, hd/16 k-steps)
// into 64 float32 registers a thread, scales it by log2(e)/sqrt(hd) after
// the product, masks it only on tiles that cross the diagonal, the window
// edge or Skv (and skips a tile none of its 64 rows can see), and updates
// the row max with two quad shuffles. p = exp2(s - m) goes to bf16 in
// registers, where the accumulator fragment of one 16-key slice is exactly
// the A fragment of the next product, so O += P V runs as wgmma.m64nHDk16
// with A from registers and V as an MN-major B operand (the transpose flag
// 16-bit types allow): no shared-memory round trip. The epilogue divides by
// the quad-summed denominator and stores bf16 pairs with bounds checks.
//
// Trouble spots, as solved:
//   - Descriptors. K-major operands (q, k) use the 128B-swizzle layout with
//     a stride byte offset of 1024 (eight 128-byte rows) and advance one
//     16-element k-step by 32 bytes inside a 64-column box. V, MN-major:
//     the stride byte offset (1024) steps eight keys, the leading byte
//     offset steps from the box of columns 0-63 to that of 64-127, and one
//     16-key k-step advances 2,048 bytes.
//   - k and v are described by 3-D tensor maps [BHkv, Skv, hd] (q by
//     [BH, Sq, hd]), so a head's tail tile is zero-filled, never the next
//     head's rows: masked keys multiply zeros, not another head's values.
//   - hd 128: a 128B-swizzled box is 64 bf16 wide, so each row loads as two
//     boxes, kept as two sub-tiles; hd 80 (and any hd under 128 that is
//     not 64) pads to 128, hd <= 64 to 64, with TMA zero-filling the
//     columns past hd.
//   - Masked keys: a masked score becomes -inf, which exp2 maps to exactly
//     0 whatever the running max; the running max starts at -1e30, so a
//     row with no live key yet keeps m finite, alpha 1 and l = 0 (never the
//     exp(-1e30 - m) = 1 of a -1e30 score against an unset max).
//   - Decode-shaped calls (Sq = 1): 127 of the block's 128 rows are TMA
//     zero-fill; they compute harmlessly and the store skips them.
//   - Registers: __launch_bounds__(288, 1) leaves up to 224 registers a
//     thread, above the consumers' need (S 64, O 32 or 64, P 32), so the
//     producer warp does not hand registers over with setmaxnreg; ptxas's
//     report (`build_info["log"]`, printed by chip_smoke.py) shows the
//     count and any spill.
//   - Build: raw PTX through inline asm, no CuTe; cuTensorMapEncodeTiled is
//     taken from the runtime's driver entry point, so no -lcuda. The TMA,
//     descriptor and wait helpers live in tma_wgmma.cuh, shared with
//     topk_sim.cu's wgmma route.
//
// fma design. One block of 256 threads per (64 query rows, head). The block
// keeps its q tile in shared memory and streams 64-row k/v tiles through it,
// only the tiles that hold a live key. Each thread owns a 4 x 4 patch of the
// 64 x 64 score tile and 4 rows x (hd/16) columns of the output; q and k are
// stored transposed (d-major) so a thread reads its four rows and its four
// keys as one 16-byte load each. Row maxima and sums are reduced across the
// 16 threads of a row with warp shuffles. The probabilities go through
// shared memory, transposed, to the PV product. Masked scores contribute
// exactly zero (a live flag; a row with no live key yet keeps its sum at 0).

#include <cuda.h>  // CUtensorMap and its enums only: nothing links libcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mbarrier.cuh"
#include "tma_wgmma.cuh"  // TMA loads, wgmma descriptors and waits, the tensor-map encoder

namespace {

constexpr float NEG = -1e30f;  // the running max before any live key (both kernels)
constexpr unsigned FULL = 0xFFFFFFFFu;

// --------------------------------------------------------------------- fma

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 x 16: thread (ty, tx) owns rows ty*4.., keys tx*4..
constexpr int SP = BQ + 4;    // stride of the transposed tiles (rows stay 16-byte aligned)

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

// ------------------------------------------------------------------- wgmma
namespace wg {

constexpr int BQ = 128;                  // query rows per block: two warpgroups of 64
constexpr int BK = 128;                  // keys per k/v tile
constexpr int STAGES = 2;                // k/v tiles in flight
constexpr int CONSUMERS = 256;           // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr int BOX = 64;                  // bf16 columns of one 128B-swizzled box
constexpr int ROW_BYTES = BOX * 2;       // 128
constexpr int SUB_Q = BQ * ROW_BYTES;    // one 64-column q box: 16 KB
constexpr int SUB_KV = BK * ROW_BYTES;   // one 64-column k or v box: 16 KB

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B in shared memory (K-major)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A in registers, B in shared memory (MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] B[16 x 128], A in registers, B in shared memory (MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// q, k, v and o are bf16; HDP (64 or 128) is hd padded to whole 64-column boxes
template <int HDP>
__global__ void __launch_bounds__(THREADS, 1)
    flash_attention_wgmma(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o,
                          int sq, int skv, int hd, int groups, int causal, int window,
                          int q_offset, float scale_log2) {
  constexpr int NSUB = HDP / BOX;           // 64-column boxes per row: 1 or 2
  constexpr int Q_BYTES = NSUB * SUB_Q;     // the q tile
  constexpr int KV_BYTES = NSUB * SUB_KV;   // one k (or v) tile
  constexpr int NO = HDP / 2;               // output accumulators a thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_q = base;                           // [NSUB][BQ][64]
  const uint32_t s_k = s_q + Q_BYTES;                  // [STAGES][NSUB][BK][64]
  const uint32_t s_v = s_k + STAGES * KV_BYTES;        // [STAGES][NSUB][BK][64]
  const uint32_t bar_q = s_v + STAGES * KV_BYTES;      // the q tile has landed
  const uint32_t bar_full = bar_q + 8;                 // [STAGES] a k/v stage has landed
  const uint32_t bar_empty = bar_full + 8 * STAGES;    // [STAGES] a k/v stage is free

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  // the keys any row of this block may see: [k_begin, k_end)
  const int q_last = min(q0 + BQ, sq) - 1;
  int k_end = skv;
  if (causal) k_end = min(k_end, q_offset + q_last + 1);
  int k_begin = window > 0 ? max(0, q_offset + q0 - window + 1) : 0;
  k_begin = (k_begin / BK) * BK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // the producer warp: one lane issues every copy
    if (threadIdx.x == CONSUMERS) {
      const int kv = bh / groups;
      mbar_expect_tx(bar_q, Q_BYTES);
      for (int c = 0; c < NSUB; ++c) tma_load_3d(s_q + c * SUB_Q, &qmap, bar_q, c * BOX, q0, bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        // wait until both warpgroups are done with this stage's last tile
        if (t >= STAGES) mbar_wait(bar_empty + 8 * s, ((t / STAGES) - 1) & 1);
        const uint32_t full = bar_full + 8 * s;
        mbar_expect_tx(full, 2 * KV_BYTES);  // out-of-bounds rows count too: TMA fills zeros
        const int k0 = k_begin + t * BK;
        for (int c = 0; c < NSUB; ++c) {
          tma_load_3d(s_k + s * KV_BYTES + c * SUB_KV, &kmap, full, c * BOX, k0, kv);
          tma_load_3d(s_v + s * KV_BYTES + c * SUB_KV, &vmap, full, c * BOX, k0, kv);
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns rows wg*64 .. wg*64+63 of the block;
  // this thread holds rows r and r + 8 and, in each 8-column group of S and
  // O, columns c and c + 1 (wgmma's accumulator fragment)
  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int row = wg * 64 + warp * 16 + lane / 4;
  const int col = (lane % 4) * 2;
  const int qpos0 = q_offset + q0 + row, qpos1 = qpos0 + 8;
  const int wg_first = q_offset + q0 + wg * 64, wg_last = wg_first + 63;
  const float minus_inf = __uint_as_float(0xff800000u);

  float oacc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) oacc[i] = 0.f;
  float m0 = NEG, m1 = NEG;  // running max of rows r, r + 8 (log2 units)
  float l0 = 0.f, l1 = 0.f;  // this thread's part of their denominators
  const uint32_t q_wg = s_q + wg * 64 * ROW_BYTES;

  mbar_wait(bar_q, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % STAGES;
    const int k0 = k_begin + t * BK;
    mbar_wait(bar_full + 8 * s, (t / STAGES) & 1);
    // a tile none of this warpgroup's rows can see: all future, or all expired
    const bool dead = (causal && k0 > wg_last) || (window > 0 && k0 + BK - 1 <= wg_first - window);
    if (!dead) {
      float sacc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) sacc[i] = 0.f;
      const uint32_t k_tile = s_k + s * KV_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk) {
        const uint32_t step = (kk / 4) * SUB_Q + (kk % 4) * 32;
        const uint32_t kstep = (kk / 4) * SUB_KV + (kk % 4) * 32;
        wgmma_ss_n128(sacc, smem_desc(q_wg + step, 16, 8 * ROW_BYTES),
                      smem_desc(k_tile + kstep, 16, 8 * ROW_BYTES), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(sacc);

      // the mask only where the tile crosses Skv, the diagonal or the window edge
      const bool edge = k0 + BK > skv || (causal && k0 + BK - 1 > wg_first) ||
                        (window > 0 && k0 <= wg_last - window);
      float mx0 = NEG, mx1 = NEG;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sacc[j * 4 + e] * scale_log2;
          if (edge) {
            const int kp = k0 + j * 8 + col + (e & 1);
            const int qp = e < 2 ? qpos0 : qpos1;
            bool ok = kp < skv;
            if (causal) ok = ok && kp <= qp;
            if (window > 0) ok = ok && kp > qp - window;
            if (!ok) x = minus_inf;
          }
          sacc[j * 4 + e] = x;
          if (e < 2) mx0 = fmaxf(mx0, x);
          else mx1 = fmaxf(mx1, x);
        }
      }
      // the four threads of a row hold its 128 scores
      mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float alpha0 = exp2f(m0 - mn0), alpha1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;

      // p in bf16 pairs: 16 keys of the accumulator are one A fragment of PV
      uint32_t pa[32];
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float p0 = exp2f(sacc[j * 4 + 0] - mn0), p1 = exp2f(sacc[j * 4 + 1] - mn0);
        const float p2 = exp2f(sacc[j * 4 + 2] - mn1), p3 = exp2f(sacc[j * 4 + 3] - mn1);
        rs0 += p0 + p1;
        rs1 += p2 + p3;
        pa[j * 2] = pack_bf16(p0, p1);
        pa[j * 2 + 1] = pack_bf16(p2, p3);
      }
      l0 = l0 * alpha0 + rs0;
      l1 = l1 * alpha1 + rs1;
#pragma unroll
      for (int i = 0; i < NO; i += 4) {
        oacc[i] *= alpha0;
        oacc[i + 1] *= alpha0;
        oacc[i + 2] *= alpha1;
        oacc[i + 3] *= alpha1;
      }

      const uint32_t v_tile = s_v + s * KV_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t a[4] = {pa[kk * 4], pa[kk * 4 + 1], pa[kk * 4 + 2], pa[kk * 4 + 3]};
        const uint64_t db = smem_desc(v_tile + kk * 16 * ROW_BYTES, SUB_KV, 8 * ROW_BYTES);
        if constexpr (HDP == 64) wgmma_rs_n64(oacc, a, db);
        else wgmma_rs_n128(oacc, a, db);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(oacc);
    }
    mbar_arrive(bar_empty + 8 * s);
  }

  l0 += __shfl_xor_sync(FULL, l0, 1);
  l0 += __shfl_xor_sync(FULL, l0, 2);
  l1 += __shfl_xor_sync(FULL, l1, 1);
  l1 += __shfl_xor_sync(FULL, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  const int r0 = q0 + row, r1 = r0 + 8;
  __nv_bfloat16* ob = o + static_cast<size_t>(bh) * sq * hd;
#pragma unroll
  for (int i = 0; i < NO / 4; ++i) {
    const int c = i * 8 + col;  // hd % 8 == 0: c + 1 < hd whenever c < hd
    if (c >= hd) continue;
    if (r0 < sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<size_t>(r0) * hd + c) =
          __floats2bfloat162_rn(oacc[i * 4] / d0, oacc[i * 4 + 1] / d0);
    if (r1 < sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<size_t>(r1) * hd + c) =
          __floats2bfloat162_rn(oacc[i * 4 + 2] / d1, oacc[i * 4 + 3] / d1);
  }
}

// a bf16 tensor [rows, seq, hd], contiguous, read as [64 x BQ] (= [64 x BK])
// boxes in 128B swizzle; rows past seq and columns past hd read as zeros
cudaError_t make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int rows, int seq,
                     int hd) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(hd) * 2,
                                 static_cast<cuuint64_t>(seq) * hd * 2};
  const cuuint32_t box[3] = {BOX, BQ, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int HDP>
int launch(const void* q, const void* k, const void* v, void* o, int bh, int groups, int sq,
           int skv, int hd, int causal, int window, int q_offset, float scale,
           cudaStream_t stream) {
  static const EncodeTiled encode = load_encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  static_assert(BQ == BK, "q and k/v share one box shape");
  CUtensorMap qmap, kmap, vmap;
  cudaError_t err = make_map(encode, &qmap, q, bh, sq, hd);
  if (err == cudaSuccess) err = make_map(encode, &kmap, k, bh / groups, skv, hd);
  if (err == cudaSuccess) err = make_map(encode, &vmap, v, bh / groups, skv, hd);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int NSUB = HDP / BOX;
  // tiles, 5 mbarriers, and slack to align the tiles to 1024 bytes
  const size_t smem = NSUB * SUB_Q + 2 * STAGES * NSUB * SUB_KV + 8 * (1 + 2 * STAGES) + 1024;
  err = cudaFuncSetAttribute(flash_attention_wgmma<HDP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + BQ - 1) / BQ, bh);
  constexpr float LOG2E = 1.4426950408889634f;
  flash_attention_wgmma<HDP><<<grid, THREADS, smem, stream>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(o), sq, skv, hd, groups, causal, window,
      q_offset, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg
}  // namespace

extern "C" {

// Pointers are device pointers on `device`; `stream` is a cudaStream_t.
// dtype: 0 float32, 1 bfloat16 (q, k, v and o share it). The float32 FMA
// kernel; bf16 that the wgmma kernel takes goes to flash_attention_wgmma_launch.
// Returns the launch's cudaError_t (0 on success).
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

// The bf16 tensor-core kernel: q, k, v, o bf16, hd % 8 == 0, hd <= 128,
// every pointer 16-byte aligned, skv >= 1.
int flash_attention_wgmma_launch(int device, const void* q, const void* k, const void* v,
                                 void* o, int bh, int groups, int sq, int skv, int hd,
                                 int causal, int window, int q_offset, float scale,
                                 void* stream) {
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (hd < 8 || hd > 128 || hd % 8 != 0 || bh < 1 || bh > 65535 || groups < 1 ||
      bh % groups != 0 || sq < 1 || skv < 1 || !aligned(q) || !aligned(k) || !aligned(v) ||
      !aligned(o)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  if (hd <= 64)
    return wg::launch<64>(q, k, v, o, bh, groups, sq, skv, hd, causal, window, q_offset, scale,
                          s);
  return wg::launch<128>(q, k, v, o, bh, groups, sq, skv, hd, causal, window, q_offset, scale,
                         s);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
