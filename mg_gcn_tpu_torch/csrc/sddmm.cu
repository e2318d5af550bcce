// SDDMM for NVIDIA Hopper (sm_90a): one score per stored entry of a CSR
// structure,
//
//   s_e = sum_d f32(A[r_e, d]) * f32(B[c_e, d])            (float32, bfloat16)
//   s_e = sum_d f32(aq[r_e, d] * bq[c_e, d]) * g[d]         (int8, g = qa * qb)
//
// with float32 sums, written in CSR entry order. Replaces the two TPU
// kernels of mg_gcn_tpu/ops/sddmm.py:
//   mggcn_sddmm        <-  _sddmm_kernel       (sddmm.py:123): every row
//   mggcn_sddmm_qskip  <-  _sddmm_kernel_qskip (sddmm.py:61): only the rows
//       of a device-side list of rows with entries (the counterpart of the
//       per-chunk live q-ranges, _chunk_q_ranges, sddmm.py:230-242)
// The TPU kernels selected A and B rows with one-hot MXU matmuls, ran their
// steps column-window-major and un-permuted the scores afterwards; here a
// gather is an ordinary load, and the structure is the edge engine's
// row-sorted CSR (indptr int64, indices int32; csr_walk.cuh's conventions).
//
// Design: one warp per row, A's row read once per row (narrow) or once per
// four entries from L1 (wide).
//   narrow (d_pad <= 32, most launches of the GAT path: d = 1 and 2 pad to
//     8): the lanes span entries; each lane holds A[r] in registers and
//     computes its entries' whole dots, kU entries in flight, so no lane
//     idles on a short feature axis;
//   wide (d_pad > 32): the lanes span features (4 a lane per 128-feature
//     chunk, chunks looped for any width), four entries at a time, each
//     entry's partial sums reduced with __shfl_xor_sync; a lane keeps the
//     score of the entry of its own index, so a warp writes 32 scores in one
//     coalesced store.
// Each score is written once; no atomics; the sum order depends only on
// d_pad, so both entry points give bitwise-equal scores. In int8 the
// product aq * bq (|.| <= 127^2, exact in float32) is rounded times g[d]
// before the float32 add, as the TPU kernel scales before its reduce.
//
// What bounds it on an H100 SXM (3.35 TB/s): bytes. At the GAT shape
// (n = 232,968, nnz = 114,964,049) the indices and the scores move 0.92 GB,
// >= 0.28 ms whatever d; 2 * nnz * d operations are far below any peak. As
// in the row walk, each entry reads a B row: nnz * d_pad * size bytes
// (1.8 GB at d_pad 8 bf16), which only the 50 MB L2 can turn into less
// device-memory traffic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kWarps = 8;  // rows (= warps) per block
constexpr unsigned kFull = 0xffffffffu;

// Four and eight consecutive features, widened to float32.
__device__ __forceinline__ float4 load4f(const float* p) { return __ldg(reinterpret_cast<const float4*>(p)); }
__device__ __forceinline__ float4 load4f(const __nv_bfloat16* p) {
  uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 lo = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ float4 load4f(const int8_t* p) {
  const char4 v = __ldg(reinterpret_cast<const char4*>(p));
  return make_float4((float)v.x, (float)v.y, (float)v.z, (float)v.w);
}
template <typename T>
__device__ __forceinline__ void load8f(const T* p, float* v) {
  const float4 lo = load4f(p), hi = load4f(p + 4);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

// One term of a score. int8 (G): the exact integer product times g[d],
// rounded, then added (no fused multiply-add: the TPU rounds the scaled
// product before its reduce). Float: a fused multiply-add.
template <bool G>
__device__ __forceinline__ float term(float a, float b, float g, float acc) {
  if constexpr (G) return __fadd_rn(acc, __fmul_rn(a * b, g));
  else return fmaf(a, b, acc);
}

template <typename T, bool SKIP, int NG>
__global__ void __launch_bounds__(kWarps * 32)
sddmm_narrow(const long long* __restrict__ indptr, const int* __restrict__ indices,
             const int* __restrict__ rows, const T* __restrict__ a, const T* __restrict__ b,
             const float* __restrict__ g, float* __restrict__ out, long long n_work) {
  constexpr bool G = std::is_same<T, int8_t>::value;
  constexpr int D = 8 * NG;                              // = d_pad
  constexpr int kU = NG == 1 ? 4 : (NG == 2 ? 2 : 1);   // entries in flight a lane
  const int lane = threadIdx.x & 31;
  const long long wi = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (wi >= n_work) return;  // warp-uniform
  const long long r = SKIP ? (long long)__ldg(rows + wi) : wi;
  const long long e0 = indptr[r], e1 = indptr[r + 1];
  if (e0 == e1) return;
  float ar[D], gr[D];
#pragma unroll
  for (int k = 0; k < NG; ++k) {
    load8f(a + (size_t)r * D + 8 * k, ar + 8 * k);
    if constexpr (G) load8f(g + 8 * k, gr + 8 * k);
    else {
#pragma unroll
      for (int f = 0; f < 8; ++f) gr[8 * k + f] = 0.f;
    }
  }
  for (long long e = e0 + lane; e < e1; e += 32 * kU) {
    int c[kU];
    float bv[kU][D];
#pragma unroll
    for (int q = 0; q < kU; ++q) c[q] = e + 32 * q < e1 ? __ldg(indices + e + 32 * q) : -1;
#pragma unroll
    for (int q = 0; q < kU; ++q) {
#pragma unroll
      for (int k = 0; k < NG; ++k) {
        if (c[q] >= 0) load8f(b + (size_t)c[q] * D + 8 * k, bv[q] + 8 * k);
        else {
#pragma unroll
          for (int f = 0; f < 8; ++f) bv[q][8 * k + f] = 0.f;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kU; ++q) {
      float acc = 0.f;
#pragma unroll
      for (int f = 0; f < D; ++f) acc = term<G>(ar[f], bv[q][f], gr[f], acc);
      if (c[q] >= 0) out[e + 32 * q] = acc;
    }
  }
}

constexpr int kWideU = 4;  // entries a warp scores at once in the wide kernel

template <typename T, bool SKIP>
__global__ void __launch_bounds__(kWarps * 32)
sddmm_wide(const long long* __restrict__ indptr, const int* __restrict__ indices,
           const int* __restrict__ rows, const T* __restrict__ a, const T* __restrict__ b,
           const float* __restrict__ g, float* __restrict__ out, long long n_work, int d_pad) {
  constexpr bool G = std::is_same<T, int8_t>::value;
  const int lane = threadIdx.x & 31;
  const long long wi = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (wi >= n_work) return;  // warp-uniform
  const long long r = SKIP ? (long long)__ldg(rows + wi) : wi;
  const long long e0 = indptr[r], e1 = indptr[r + 1];
  const T* arow = a + (size_t)r * d_pad;
  for (long long e = e0; e < e1; e += 32) {
    const int cnt = (int)(e1 - e < 32 ? e1 - e : 32);
    const int col = lane < cnt ? __ldg(indices + e + lane) : 0;
    float mine = 0.f;  // the score of entry e + lane
    for (int j = 0; j < cnt; j += kWideU) {
      int cj[kWideU];
      float part[kWideU];
#pragma unroll
      for (int q = 0; q < kWideU; ++q) {
        cj[q] = __shfl_sync(kFull, col, (j + q) & 31);
        part[q] = 0.f;
      }
      for (int f = lane * 4; f < d_pad; f += 128) {
        const float4 av = load4f(arow + f);
        const float4 gv = G ? __ldg(reinterpret_cast<const float4*>(g + f)) : make_float4(0.f, 0.f, 0.f, 0.f);
        float4 bv[kWideU];
#pragma unroll
        for (int q = 0; q < kWideU; ++q)
          bv[q] = j + q < cnt ? load4f(b + (size_t)cj[q] * d_pad + f) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int q = 0; q < kWideU; ++q) {
          part[q] = term<G>(av.x, bv[q].x, gv.x, part[q]);
          part[q] = term<G>(av.y, bv[q].y, gv.y, part[q]);
          part[q] = term<G>(av.z, bv[q].z, gv.z, part[q]);
          part[q] = term<G>(av.w, bv[q].w, gv.w, part[q]);
        }
      }
#pragma unroll
      for (int q = 0; q < kWideU; ++q) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) part[q] += __shfl_xor_sync(kFull, part[q], off);
        if (lane == j + q) mine = part[q];
      }
    }
    if (lane < cnt) out[e + lane] = mine;
  }
}

template <typename T, bool SKIP>
int launch(const void* indptr, const void* indices, const void* rows, const void* a, const void* b,
           const void* g, void* out, long long n_work, int d_pad, cudaStream_t stream) {
  if (n_work <= 0 || n_work > (long long)kWarps * 0x7fffffffLL || d_pad <= 0 || d_pad % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (std::is_same<T, int8_t>::value && g == nullptr) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((n_work + kWarps - 1) / kWarps));
  const auto* ip = static_cast<const long long*>(indptr);
  const auto* ix = static_cast<const int*>(indices);
  const auto* rw = static_cast<const int*>(rows);
  const auto* at = static_cast<const T*>(a);
  const auto* bt = static_cast<const T*>(b);
  const auto* gt = static_cast<const float*>(g);
  auto* o = static_cast<float*>(out);
  switch (d_pad) {
    case 8: sddmm_narrow<T, SKIP, 1><<<grid, kWarps * 32, 0, stream>>>(ip, ix, rw, at, bt, gt, o, n_work); break;
    case 16: sddmm_narrow<T, SKIP, 2><<<grid, kWarps * 32, 0, stream>>>(ip, ix, rw, at, bt, gt, o, n_work); break;
    case 24: sddmm_narrow<T, SKIP, 3><<<grid, kWarps * 32, 0, stream>>>(ip, ix, rw, at, bt, gt, o, n_work); break;
    case 32: sddmm_narrow<T, SKIP, 4><<<grid, kWarps * 32, 0, stream>>>(ip, ix, rw, at, bt, gt, o, n_work); break;
    default: sddmm_wide<T, SKIP><<<grid, kWarps * 32, 0, stream>>>(ip, ix, rw, at, bt, gt, o, n_work, d_pad);
  }
  return (int)cudaGetLastError();
}

template <bool SKIP>
int dispatch(const void* indptr, const void* indices, const void* rows, const void* a, const void* b,
             const void* g, void* out, long long n_work, int d_pad, int dtype, cudaStream_t s) {
  switch (dtype) {
    case 0: return launch<float, SKIP>(indptr, indices, rows, a, b, g, out, n_work, d_pad, s);
    case 1: return launch<__nv_bfloat16, SKIP>(indptr, indices, rows, a, b, g, out, n_work, d_pad, s);
    case 2: return launch<int8_t, SKIP>(indptr, indices, rows, a, b, g, out, n_work, d_pad, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Scores of every entry of the n_out rows. A (n_out, d_pad), B (n_in,
// d_pad) row-major, both of dtype 0 = float32, 1 = bfloat16, 2 = int8; g
// (d_pad) float32 in int8 (ignored otherwise); out (nnz) float32. Returns a
// cudaError_t; 0 means the launch was accepted.
int mggcn_sddmm(const void* indptr, const void* indices, const void* a, const void* b, const void* g,
                void* out, long long n_out, int d_pad, int dtype, void* stream) {
  return dispatch<false>(indptr, indices, nullptr, a, b, g, out, n_out, d_pad, dtype,
                         static_cast<cudaStream_t>(stream));
}

// The same scores, launched over the n_live rows listed in rows (int32):
// the rows with at least one entry.
int mggcn_sddmm_qskip(const void* indptr, const void* indices, const void* rows, const void* a,
                      const void* b, const void* g, void* out, long long n_live, int d_pad, int dtype,
                      void* stream) {
  return dispatch<true>(indptr, indices, rows, a, b, g, out, n_live, d_pad, dtype,
                        static_cast<cudaStream_t>(stream));
}

const char* mggcn_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
