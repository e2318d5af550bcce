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
// Design: one warp per output row, split into G = 32 / L groups of L lanes.
// A lane loads 4 features of a B row (kLaneF), so a group covers 4L
// features; L is the smallest power of two >= d_pad / 4, capped at 32
// (lanes_for): d_pad 8 gives L = 2 and G = 16, d_pad 48 and 64 give L = 16
// and G = 2, d_pad >= 128 gives L = 32 and G = 1, one group over the row.
// Group k takes the row's entries e0 + k, e0 + k + G, e0 + k + 2G, ... in
// order, so every lane has work at every width. The row's (col, w) pairs
// are read max(8, L) a group at a time in coalesced loads and handed to
// the groups with __shfl_sync; each lane keeps kUnroll B rows in flight and
// its sums in registers. The G partial sums then meet by a fixed
// __shfl_xor_sync tree (groups 2i and 2i + 1 first, then pairs of pairs)
// and group 0 writes the row once (zeros for an empty row): no atomics,
// one sum order, so two launches give the same bits. At G = 1 this is a
// warp over the features with the entries in order. Widths past 128 take
// NV 128-feature chunks a pass (1 for d_pad <= 128, else 2), and passes
// loop over wider operands, re-reading the row's entries.
//
// What bounds it: the bytes of indices and weights (each read once), B and
// C. At narrow widths B is small enough to stay in the 50 MB L2 (d_pad 8
// bf16 on the 232,968-node GAT graph: 3.7 MB), so each entry's B row is an
// L2 read and the walk is bound by the 6 bytes of index and weight an
// entry (0.69 GB, >= 0.207 ms at 3.35 TB/s). Before the groups, 30 of a
// warp's 32 lanes sat idle at d_pad 8 and the walk took the same time at
// every width: its chain of shuffles and dependent loads, one entry at a
// time, bound it, not bytes.
//
// B and C are row-major (rows, d_pad) with d_pad % 8 == 0. Offsets: indptr
// is int64 and every B/C offset is size_t (2.45M rows x 256 features x 4
// bytes passes 2^31 bytes).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "async_copy.cuh"

namespace csr {

constexpr int kWarps = 8;             // output rows (= warps) per block
constexpr int kLaneF = 4;             // features per lane per chunk
constexpr int kWideF = 32 * kLaneF;   // features per warp per chunk at G = 1
constexpr int kGroupE = 8;            // entries a group takes from a batch, at least
constexpr int kUnroll = 4;            // entries whose B rows a lane loads at once
constexpr unsigned kFull = 0xffffffffu;

// Lanes a group: the smallest power of two >= d_pad / 4, capped at 32.
inline int lanes_for(int d_pad) {
  int l = 2;
  while (l < 32 && l * kLaneF < d_pad) l *= 2;
  return l;
}

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
// a += the sums of the lane ``off`` lanes away (a step of the xor tree).
__device__ __forceinline__ void add_xor(float4& a, int off) {
  a.x += __shfl_xor_sync(kFull, a.x, off); a.y += __shfl_xor_sync(kFull, a.y, off);
  a.z += __shfl_xor_sync(kFull, a.z, off); a.w += __shfl_xor_sync(kFull, a.w, off);
}
__device__ __forceinline__ void add_xor(int4& a, int off) {
  a.x += __shfl_xor_sync(kFull, a.x, off); a.y += __shfl_xor_sync(kFull, a.y, off);
  a.z += __shfl_xor_sync(kFull, a.z, off); a.w += __shfl_xor_sync(kFull, a.w, off);
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

template <typename WT, typename BT, bool HAS_W, int L, int NV, bool PERM>
__global__ void __launch_bounds__(kWarps * 32)
walk_kernel(const long long* __restrict__ indptr, const int* __restrict__ indices,
            const WT* __restrict__ w, const BT* __restrict__ b,
            typename Acc<BT>::T* __restrict__ c, long long n_out, int d_pad,
            const int* __restrict__ perm) {
  using A = typename Acc<BT>::T;
  using A4 = typename Acc<BT>::T4;
  static_assert(L >= 2 && L <= 32 && (L & (L - 1)) == 0 && (NV == 1 || L == 32), "lanes a group");
  constexpr int G = 32 / L;                          // groups a warp
  constexpr int kChunk = L * kLaneF;                 // features a group covers a chunk
  constexpr int kE = L < kGroupE ? kGroupE : L;      // entries a group takes from a batch
  constexpr int kR = kE / L;                         // index registers a lane
  constexpr int kBatch = 32 * kR;                    // entries a warp reads at once
  const int lane = threadIdx.x & 31, grp = lane / L, gl = lane % L;
  const long long r = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= n_out) return;  // warp-uniform
  const long long e0 = indptr[r], e1 = indptr[r + 1];
  for (int pass = 0; pass < d_pad; pass += NV * kChunk) {
    A4 acc[NV];
    bool on[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      zero(acc[v]);
      on[v] = pass + v * kChunk + gl * kLaneF < d_pad;
    }
    const BT* bl = b + pass + gl * kLaneF;
    for (long long e = e0; e < e1; e += kBatch) {
      const int cnt = (int)(e1 - e < kBatch ? e1 - e : kBatch);
      // batch entry 32 i + lane lives in lane ``lane``'s col[i], wt[i]
      int col[kR];
      A wt[kR];
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const int k = 32 * i + lane;
        col[i] = 0;
        wt[i] = A(0);
        if (k < cnt) {
          col[i] = __ldg(indices + e + k);
          if constexpr (HAS_W) wt[i] = weight(w + (PERM ? (long long)__ldg(perm + e + k) : e + k));
        }
      }
      // Two spellings of one step (shuffle kUnroll entries' column and weight to the group,
      // load their B rows, sum): one loop body for both compiled to a slower G = 1 walk.
      if constexpr (G == 1) {
        // the warp's entries in order, kUnroll at a time
        for (int j = 0; j < cnt; j += kUnroll) {
          int cj[kUnroll];
          A wj[kUnroll];
          A4 x[kUnroll][NV];
#pragma unroll
          for (int q = 0; q < kUnroll; ++q) {
            cj[q] = __shfl_sync(kFull, col[0], (j + q) & 31);
            if constexpr (HAS_W) wj[q] = __shfl_sync(kFull, wt[0], (j + q) & 31);
          }
#pragma unroll
          for (int q = 0; q < kUnroll; ++q) {
#pragma unroll
            for (int v = 0; v < NV; ++v) {
              zero(x[q][v]);  // stays zero past the row's last entry
              if (j + q < cnt && on[v]) x[q][v] = load4(bl + (size_t)cj[q] * d_pad + v * kChunk);
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
      } else {
        // the group's q-th entry of the batch is batch entry 32 (q / L) + grp + G (q % L),
        // in lane grp + G (q % L)'s register q / L; the loop unrolls, so that the register
        // is known at compile time
#pragma unroll
        for (int q0 = 0; q0 < kE; q0 += kUnroll) {
          if (32 * (q0 / L) + G * (q0 % L) >= cnt) break;  // group 0's first entry here: warp-uniform
          int cj[kUnroll];
          A wj[kUnroll];
          bool ok[kUnroll];
          A4 x[kUnroll][NV];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int q = q0 + u, src = grp + G * (q % L);
            cj[u] = __shfl_sync(kFull, col[q / L], src);
            if constexpr (HAS_W) wj[u] = __shfl_sync(kFull, wt[q / L], src);
            ok[u] = 32 * (q / L) + src < cnt;
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
            for (int v = 0; v < NV; ++v) {
              zero(x[u][v]);  // stays zero past the row's last entry
              if (ok[u] && on[v]) x[u][v] = load4(bl + (size_t)cj[u] * d_pad + v * kChunk);
            }
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
            for (int v = 0; v < NV; ++v) {
              if constexpr (HAS_W) madd(acc[v], ok[u] ? wj[u] : A(0), x[u][v]);
              else add(acc[v], x[u][v]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int off = L; off < 32; off <<= 1) {
#pragma unroll
      for (int v = 0; v < NV; ++v) add_xor(acc[v], off);
    }
    if (grp == 0) {
      A* cr = c + (size_t)r * d_pad + pass + gl * kLaneF;
#pragma unroll
      for (int v = 0; v < NV; ++v)
        if (on[v]) *reinterpret_cast<A4*>(cr + v * kChunk) = acc[v];
    }
  }
}

inline bool bad_shape(long long n_out, int d_pad) {
  return n_out <= 0 || n_out > (long long)kWarps * 0x7fffffffLL || d_pad <= 0 || d_pad % 8 != 0;
}

template <typename WT, typename BT>
using Kernel = void (*)(const long long*, const int*, const WT*, const BT*, typename Acc<BT>::T*, long long, int,
                        const int*);

// The walk for a width: L lanes a group by lanes_for, and at L = 32 one or
// two 128-feature chunks a pass. The one place that picks the schedule.
template <typename WT, typename BT, bool HAS_W, bool PERM>
Kernel<WT, BT> pick(int d_pad) {
  switch (lanes_for(d_pad)) {
    case 2: return walk_kernel<WT, BT, HAS_W, 2, 1, PERM>;
    case 4: return walk_kernel<WT, BT, HAS_W, 4, 1, PERM>;
    case 8: return walk_kernel<WT, BT, HAS_W, 8, 1, PERM>;
    case 16: return walk_kernel<WT, BT, HAS_W, 16, 1, PERM>;
    default:
      if (d_pad <= kWideF) return walk_kernel<WT, BT, HAS_W, 32, 1, PERM>;
      return walk_kernel<WT, BT, HAS_W, 32, 2, PERM>;
  }
}

inline dim3 grid_for(long long n_out) { return dim3((unsigned)((n_out + kWarps - 1) / kWarps)); }

// Launches the walk on `stream`; w is ignored when HAS_W is false, perm
// unless PERM. Returns a cudaError_t; 0 means the launch was accepted.
template <typename WT, typename BT, bool HAS_W, bool PERM = false>
int launch(const void* indptr, const void* indices, const void* w, const void* b, void* c,
           long long n_out, int d_pad, cudaStream_t stream, const void* perm = nullptr) {
  if (bad_shape(n_out, d_pad)) return (int)cudaErrorInvalidValue;
  pick<WT, BT, HAS_W, PERM>(d_pad)<<<grid_for(n_out), kWarps * 32, 0, stream>>>(
      static_cast<const long long*>(indptr), static_cast<const int*>(indices), static_cast<const WT*>(w),
      static_cast<const BT*>(b), static_cast<typename Acc<BT>::T*>(c), n_out, d_pad, static_cast<const int*>(perm));
  return (int)cudaGetLastError();
}

// The walk's launch geometry for n_out rows of width d_pad, written to
// out[0..8]: async_copy::write_geometry's seven values (grid x, grid y,
// threads, dynamic shared memory 0, B rows a lane has in flight in the
// stages slot, resident blocks an SM, resident blocks on the card), then L
// and G. Returns a cudaError_t.
template <typename WT, typename BT, bool HAS_W, bool PERM = false>
int geometry(long long n_out, int d_pad, int* out) {
  if (bad_shape(n_out, d_pad)) return (int)cudaErrorInvalidValue;
  const cudaError_t err = async_copy::write_geometry(pick<WT, BT, HAS_W, PERM>(d_pad), kWarps * 32, 0,
                                                     grid_for(n_out), kUnroll, out);
  if (err != cudaSuccess) return (int)err;
  out[7] = lanes_for(d_pad);
  out[8] = 32 / out[7];
  return 0;
}

}  // namespace csr
