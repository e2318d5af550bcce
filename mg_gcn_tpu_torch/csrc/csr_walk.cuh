// The CSR row walk of the edge and gather kernels (spmm_edges.cu,
// spmm_gather.cu) for NVIDIA Hopper (sm_90a).
//
//   C[r, :] = sum_e w_e * B[c_e, :]
//
// over row r's entries of a row-sorted CSR matrix (indptr int64, indices
// int32), with w_e = 1 in a binary walk (HAS_W false). WT is the weights'
// type, BT the operand's; the sums and C are float32, or int32 (exact) for
// an int8 operand. bfloat16 weights and operands are widened to float32 at
// load. With PERM, entry e's weight is w[perm[e]]: the walk of a CSR
// transpose reads the weights of the matrix it transposes in place, so a
// permuted copy of them is never written (the edge_t kernel).
//
// Design: one warp per output row, lanes spanning the features (4 a lane,
// so a warp reads a B row's 128-feature chunk as one coalesced request),
// the row's (col, w) pairs read 32 at a time in one coalesced load and
// broadcast with __shfl_sync, kUnroll B rows in flight per lane, sums in
// registers, each output row written once (zeros for an empty row): no
// atomics, deterministic. Every width runs in one launch: NV 128-feature
// chunks per pass (1 for d_pad <= 128, else 2), and passes loop over wider
// operands, re-reading the row's entries.
//
// B and C are row-major (rows, d_pad) with d_pad % 8 == 0. Offsets: indptr
// is int64 and every B/C offset is size_t (2.45M rows x 256 features x 4
// bytes passes 2^31 bytes).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace csr {

constexpr int kWarps = 8;             // output rows (= warps) per block
constexpr int kLaneF = 4;             // features per lane per 128-feature chunk
constexpr int kChunkF = 32 * kLaneF;  // features per warp per chunk
constexpr int kUnroll = 4;            // entries whose B rows are loaded at once
constexpr unsigned kFull = 0xffffffffu;

// The accumulator for an operand type: float32, or int32 for int8.
template <typename BT> struct Acc {
  using T = float;
  using T4 = float4;
};
template <> struct Acc<int8_t> {
  using T = int;
  using T4 = int4;
};

__device__ __forceinline__ void zero(float4& a) { a = make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ void zero(int4& a) { a = make_int4(0, 0, 0, 0); }
__device__ __forceinline__ void madd(float4& a, float w, const float4& v) {
  a.x = fmaf(w, v.x, a.x); a.y = fmaf(w, v.y, a.y);
  a.z = fmaf(w, v.z, a.z); a.w = fmaf(w, v.w, a.w);
}
__device__ __forceinline__ void madd(int4& a, int w, const int4& v) {
  a.x += w * v.x; a.y += w * v.y; a.z += w * v.z; a.w += w * v.w;
}
__device__ __forceinline__ void add(float4& a, const float4& v) {
  a.x += v.x; a.y += v.y; a.z += v.z; a.w += v.w;
}
__device__ __forceinline__ void add(int4& a, const int4& v) {
  a.x += v.x; a.y += v.y; a.z += v.z; a.w += v.w;
}

// One weight, widened to the accumulator type.
__device__ __forceinline__ float weight(const float* w) { return __ldg(w); }
__device__ __forceinline__ float weight(const __nv_bfloat16* w) { return __bfloat162float(*w); }
__device__ __forceinline__ int weight(const int8_t* w) { return (int)__ldg(w); }

// Four consecutive features of a B row, widened to the accumulator type.
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 lo = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ int4 load4(const int8_t* p) {
  const char4 v = __ldg(reinterpret_cast<const char4*>(p));
  return make_int4(v.x, v.y, v.z, v.w);
}

template <typename WT, typename BT, bool HAS_W, int NV, bool PERM>
__global__ void __launch_bounds__(kWarps * 32)
walk_kernel(const long long* __restrict__ indptr, const int* __restrict__ indices,
            const WT* __restrict__ w, const BT* __restrict__ b,
            typename Acc<BT>::T* __restrict__ c, long long n_out, int d_pad,
            const int* __restrict__ perm) {
  using A = typename Acc<BT>::T;
  using A4 = typename Acc<BT>::T4;
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= n_out) return;  // warp-uniform
  const long long e0 = indptr[r], e1 = indptr[r + 1];
  for (int pass = 0; pass < d_pad; pass += NV * kChunkF) {
    A4 acc[NV];
    bool on[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      zero(acc[v]);
      on[v] = pass + v * kChunkF + lane * kLaneF < d_pad;
    }
    const BT* bl = b + pass + lane * kLaneF;
    for (long long e = e0; e < e1; e += 32) {
      const int cnt = (int)(e1 - e < 32 ? e1 - e : 32);
      int col = 0;
      A wt = A(0);
      if (lane < cnt) {
        col = __ldg(indices + e + lane);
        if constexpr (HAS_W) wt = weight(w + (PERM ? (long long)__ldg(perm + e + lane) : e + lane));
      }
      for (int j = 0; j < cnt; j += kUnroll) {
        int cj[kUnroll];
        A wj[kUnroll];
        A4 x[kUnroll][NV];
#pragma unroll
        for (int q = 0; q < kUnroll; ++q) {
          cj[q] = __shfl_sync(kFull, col, (j + q) & 31);
          if constexpr (HAS_W) wj[q] = __shfl_sync(kFull, wt, (j + q) & 31);
        }
#pragma unroll
        for (int q = 0; q < kUnroll; ++q) {
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            zero(x[q][v]);  // stays zero past the row's last entry
            if (j + q < cnt && on[v]) x[q][v] = load4(bl + (size_t)cj[q] * d_pad + v * kChunkF);
          }
        }
#pragma unroll
        for (int q = 0; q < kUnroll; ++q) {
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            if constexpr (HAS_W) madd(acc[v], j + q < cnt ? wj[q] : A(0), x[q][v]);
            else add(acc[v], x[q][v]);
          }
        }
      }
    }
    A* cr = c + (size_t)r * d_pad + pass + lane * kLaneF;
#pragma unroll
    for (int v = 0; v < NV; ++v)
      if (on[v]) *reinterpret_cast<A4*>(cr + v * kChunkF) = acc[v];
  }
}

inline bool bad_shape(long long n_out, int d_pad) {
  return n_out <= 0 || n_out > (long long)kWarps * 0x7fffffffLL || d_pad <= 0 || d_pad % 8 != 0;
}

// Launches the walk on `stream`; w is ignored when HAS_W is false, perm
// unless PERM. Returns a cudaError_t; 0 means the launch was accepted.
template <typename WT, typename BT, bool HAS_W, bool PERM = false>
int launch(const void* indptr, const void* indices, const void* w, const void* b, void* c,
           long long n_out, int d_pad, cudaStream_t stream, const void* perm = nullptr) {
  if (bad_shape(n_out, d_pad)) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((n_out + kWarps - 1) / kWarps));
  const auto* ip = static_cast<const long long*>(indptr);
  const auto* ix = static_cast<const int*>(indices);
  const auto* wt = static_cast<const WT*>(w);
  const auto* bt = static_cast<const BT*>(b);
  auto* ct = static_cast<typename Acc<BT>::T*>(c);
  const auto* pm = static_cast<const int*>(perm);
  if (d_pad <= kChunkF)
    walk_kernel<WT, BT, HAS_W, 1, PERM><<<grid, kWarps * 32, 0, stream>>>(ip, ix, wt, bt, ct, n_out, d_pad, pm);
  else
    walk_kernel<WT, BT, HAS_W, 2, PERM><<<grid, kWarps * 32, 0, stream>>>(ip, ix, wt, bt, ct, n_out, d_pad, pm);
  return (int)cudaGetLastError();
}

}  // namespace csr
