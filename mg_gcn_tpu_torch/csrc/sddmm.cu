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
// What bounds it on an H100 SXM (3.35 TB/s): bytes to device memory. At
// the GAT shape (n = 232,968, nnz = 114,964,049) the indices and the
// scores move 0.92 GB, >= 0.28 ms whatever d; 2 * nnz * d operations are
// far below any peak. In practice each entry gathers a whole B row from
// the 50 MB L2 (B fits it: 30 MB at d_pad 64 bf16), nnz * d_pad * size
// bytes of L2 reads (14.7 GB at d_pad 64 bf16, 1.8 GB at d_pad 8), so the
// kernel has to keep enough B rows in flight and spend few instructions on
// each entry besides its loads.
//
// Design: one warp a row, split into G = 32 / L groups of L lanes. A lane
// loads F features of a B row in one load of 16 bytes (8 where an int8
// row of d_pad % 16 == 8 is only 8-byte aligned): F = 4 float32, 8 bf16,
// 16 (or 8) int8. L is the smallest power of two >= d_pad / F, capped at
// 32 (lanes_for: bf16 d_pad 8 gives L = 1, G = 32; d_pad 48 and 64 give
// L = 8, G = 4). Group k scores the row's entries e + k, e + k + G, ...,
// kU = 8 of them a batch (8 G entries a warp, 8 B rows in flight a lane),
// each lane reading its entries' columns itself (the L lanes of a group
// read one address). A's slice (and g's in int8) stays in registers.
// A lane sums its own features in order into one partial sum an entry.
// The L partial sums of an entry meet in a fixed tree: a reduce-scatter
// over R = min(L, 8) lanes (at xor offset o = 1, 2, ..., R / 2 each lane
// keeps half of its live sums and adds the other half's from lane ^ o, so
// each shuffle serves all G groups at once), then, for L > 8, an xor sum
// over offsets 8 .. L / 2. The tree is (l, l ^ 1), then pairs of pairs,
// for every entry whatever R; after it the lanes below R hold the batch's
// 8 G scores, 8 / R each, written in stores of G R consecutive scores.
// bf16 d_pad 64: 7 shuffles a batch of 32 entries; d_pad 8 (L = 1): none,
// one 16-byte load and 8 fused multiply-adds an entry. int8 widens a byte
// by a byte permute into a float's significand and a subtraction, not by
// a conversion instruction (a quarter of the float rate).
//
// A row wider than 32 F features (float32 d_pad > 128, bf16 > 256, int8 >
// 512) is walked once a chunk of 32 F features, in spans of kSpan = 1,024
// entries: each chunk's scores (lane sums, then the tree) are added in
// chunk order to running scores in the warp's shared memory (4 KiB a
// warp), and the last chunk's pass writes them out. Walking a whole span
// per chunk, not each batch's chunks in turn, keeps the gathers of one
// pass to a chunk of each B row; where B outgrows the L2 (float32 d_pad
// 256: 238 MB at n = 232,968) the batch-by-batch order ran 2.2x slower on
// an H100.
//
// Each score is written once, by one lane; no atomics; the sum order
// depends only on (dtype, d_pad), so two launches and both entry points
// give equal bits. In int8 the product aq * bq (|.| <= 127^2, exact in
// float32) is rounded times g[d] before the float32 add, as the TPU kernel
// scales before its reduce.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "async_copy.cuh"

namespace {

constexpr int kWarps = 8;  // rows (= warps) per block
constexpr int kU = 8;      // entries a group scores a batch: B rows a lane has in flight
constexpr int kSpan = 1024;  // entries of a span of a chunked row (running scores in shared memory)
constexpr unsigned kFull = 0xffffffffu;

// Bytes a lane loads of a B row: 16, or 8 where the row stride is only
// 8-byte aligned (int8 at d_pad % 16 == 8); F = that / the element size.
inline int features_for(int elt, int d_pad) { return ((d_pad * elt) % 16 == 0 ? 16 : 8) / elt; }

// Lanes a group: the smallest power of two >= d_pad / F, capped at 32.
inline int lanes_for(int f, int d_pad) {
  int l = 1;
  while (l < 32 && l * f < d_pad) l *= 2;
  return l;
}

// F consecutive features as loaded (Raw) and widened to float32.
template <typename T, int F> struct Vec;
template <> struct Vec<float, 4> {
  using Raw = float4;
  __device__ static void widen(const Raw& x, float* v) { v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w; }
};
template <> struct Vec<__nv_bfloat16, 8> {
  using Raw = uint4;
  __device__ static void widen(const Raw& x, float* v) {
    const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
};
// int8 widens without a conversion instruction (a quarter of the float
// rate): byte x ^ 0x80 = x + 128 goes into the low bits of 2^23's
// significand by a byte permute, and 2^23 + 128 is subtracted, exactly.
template <int F> struct VecI8 {
  using Raw = typename std::conditional<F == 16, uint4, uint2>::type;
  __device__ static void widen(const Raw& x, float* v) {
    const unsigned* w = reinterpret_cast<const unsigned*>(&x);
#pragma unroll
    for (int i = 0; i < F / 4; ++i) {
      const unsigned biased = w[i] ^ 0x80808080u;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        v[4 * i + k] = __uint_as_float(__byte_perm(biased, 0x4b000000u, 0x7540 + k)) - 8388736.f;
    }
  }
};
template <> struct Vec<int8_t, 16> : VecI8<16> {};
template <> struct Vec<int8_t, 8> : VecI8<8> {};

template <typename T, int F>
__device__ __forceinline__ typename Vec<T, F>::Raw load_raw(const T* p) {
  return __ldg(reinterpret_cast<const typename Vec<T, F>::Raw*>(p));
}

// One term of a score. int8 (I8): the exact integer product times g[d],
// rounded, then added (no fused multiply-add: the TPU rounds the scaled
// product before its reduce). Float: a fused multiply-add.
template <bool I8>
__device__ __forceinline__ float term(float a, float b, float g, float acc) {
  if constexpr (I8) return __fadd_rn(acc, __fmul_rn(a * b, g));
  else return fmaf(a, b, acc);
}

// The lane's slice of A (and of g in int8) at features f0 .. f0 + F - 1,
// zeros past d_pad.
template <typename T, int F, bool I8>
__device__ __forceinline__ void load_slice(const T* arow, const float* g, int f0, int d_pad, float* ar, float* gr) {
#pragma unroll
  for (int f = 0; f < F; ++f) ar[f] = gr[f] = 0.f;
  if (f0 >= d_pad) return;
  Vec<T, F>::widen(load_raw<T, F>(arow + f0), ar);
  if constexpr (I8) {
#pragma unroll
    for (int f = 0; f < F; f += 4) {
      const float4 gv = __ldg(reinterpret_cast<const float4*>(g + f0 + f));
      gr[f] = gv.x; gr[f + 1] = gv.y; gr[f + 2] = gv.z; gr[f + 3] = gv.w;
    }
  }
}

// One step of the reduce-scatter over R lanes of a group, at xor offset
// O, then the next: each of the S sets of R live sums a lane holds halves
// (h = R / 2O left), the lane keeping the half that bit O of its group lane
// gl picks and adding the other lane's sums of the same entries. After
// log2 R steps part[s R] is the sum over the lanes gl ^ m, m < R, of set
// s's entry brev(gl mod R) (the log2 R bits reversed), in the tree (l, l ^
// 1), then pairs of pairs.
template <int R, int S, int O>
__device__ __forceinline__ void reduce_scatter(float* part, int gl) {
  if constexpr (O < R) {
    constexpr int h = R / (2 * O);
    const bool hi = gl & O;
#pragma unroll
    for (int s = 0; s < S; ++s) {
#pragma unroll
      for (int j = 0; j < h; ++j) {
        const float lo_v = part[s * R + j], hi_v = part[s * R + j + h];
        const float recv = __shfl_xor_sync(kFull, hi ? lo_v : hi_v, O);
        part[s * R + j] = (hi ? hi_v : lo_v) + recv;
      }
    }
    reduce_scatter<R, S, 2 * O>(part, gl);
  }
}

__host__ __device__ constexpr int log2_of(int l) { return l <= 1 ? 0 : 1 + log2_of(l / 2); }

template <typename T, bool SKIP, int F, int L>
__global__ void __launch_bounds__(kWarps * 32)
sddmm_kernel(const long long* __restrict__ indptr, const int* __restrict__ indices,
             const int* __restrict__ rows, const T* __restrict__ a, const T* __restrict__ b,
             const float* __restrict__ g, float* __restrict__ out, long long n_work, int d_pad) {
  constexpr bool kI8 = std::is_same<T, int8_t>::value;
  constexpr int G = 32 / L;                  // groups a warp
  constexpr int R = L < kU ? L : kU;         // lanes of the reduce-scatter
  constexpr int S = kU / R;                  // scores a lane holds after it
  constexpr int kBatch = G * kU;             // entries a warp scores a batch
  constexpr int kChunk = L * F;              // features a group covers at once
  static_assert((L & (L - 1)) == 0 && L <= 32 && kSpan % kBatch == 0, "lanes a group");
  using Raw = typename Vec<T, F>::Raw;
  extern __shared__ float span_sums[];       // kSpan running scores a warp (chunked rows)
  const int lane = threadIdx.x & 31, grp = lane / L, gl = lane % L;
  const long long wi = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (wi >= n_work) return;  // warp-uniform
  const long long r = SKIP ? (long long)__ldg(rows + wi) : wi;
  const long long e0 = indptr[r], e1 = indptr[r + 1];
  if (e0 == e1) return;
  const T* arow = a + (size_t)r * d_pad;
  const int nc = L == 32 ? (d_pad + kChunk - 1) / kChunk : 1;  // chunks: 1 unless L == 32
  // the lane's score after the tree: the group's entry s R + u0 of the batch
  const int u0 = R == 1 ? 0 : (int)(__brev((unsigned)gl) >> (32 - log2_of(R)));
  float ar[F], gr[F];  // the lane's slice of A (and g) in chunk c
  // Scores entries s0 .. s1 - 1 over chunk c's features. Chunk c's score of
  // entry k is added to its running score sums[k - s0] (c > 0), then kept
  // there (c < nc - 1) or written to out (the last chunk).
  auto walk = [&](long long s0, long long s1, int c, float* sums) {
    const int f0 = c * kChunk + gl * F;
    const bool on = f0 < d_pad;
    for (long long e = s0; e < s1; e += kBatch) {
      // part[u]: this lane's partial sum of the group's u-th entry of the
      // batch, entry e + grp + G u; col[u] its column, -1 past s1. Groups
      // of L <= 8 read the batch's columns ahead of the B loads; wider ones
      // read each beside its load (fewer registers, faster there on the
      // card), and col[u] only marks the end.
      float part[kU];
      int col[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const long long k = e + grp + (long long)G * u;
        part[u] = 0.f;
        col[u] = k >= s1 ? -1 : (L <= 8 ? __ldg(indices + k) : 0);
      }
      Raw x[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        x[u] = Raw{};  // zeros past the last entry or d_pad
        if (on && col[u] >= 0) {
          const int cu = L <= 8 ? col[u] : __ldg(indices + e + grp + (long long)G * u);
          x[u] = load_raw<T, F>(b + (size_t)cu * d_pad + f0);
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        float bv[F];
        Vec<T, F>::widen(x[u], bv);
#pragma unroll
        for (int f = 0; f < F; ++f) part[u] = term<kI8>(ar[f], bv[f], gr[f], part[u]);
      }
      // the tree: the reduce-scatter over offsets 1 .. R / 2, then (L > 8)
      // sums over offsets R .. L / 2, which join lanes holding the same entry
      reduce_scatter<R, S, 1>(part, gl);
#pragma unroll
      for (int o = R; o < L; o <<= 1) {
#pragma unroll
        for (int s = 0; s < S; ++s) part[s * R] += __shfl_xor_sync(kFull, part[s * R], o);
      }
      if (gl < R) {
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const long long k = e + grp + (long long)G * (s * R + u0);
          if (k >= s1) continue;
          const float v = c > 0 ? sums[k - s0] + part[s * R] : part[s * R];
          if (c < nc - 1) sums[k - s0] = v;  // a slot only this lane touches
          else out[k] = v;
        }
      }
    }
  };
  if constexpr (L < 32) {
    load_slice<T, F, kI8>(arow, g, gl * F, d_pad, ar, gr);
    walk(e0, e1, 0, nullptr);
  } else {
    // The row in one span, or where it is wider than one chunk in spans of
    // kSpan entries, each walked once a chunk, its running scores in the
    // warp's shared slots.
    float* sums = span_sums + (threadIdx.x >> 5) * kSpan;
    const long long span = nc > 1 ? kSpan : e1 - e0;
    for (long long s0 = e0; s0 < e1; s0 += span) {
      const long long s1 = e1 - s0 < span ? e1 : s0 + span;
      for (int c = 0; c < nc; ++c) {
        load_slice<T, F, kI8>(arow, g, c * kChunk + gl * F, d_pad, ar, gr);
        walk(s0, s1, c, sums);
      }
    }
  }
}

template <typename T>
using Kernel = void (*)(const long long*, const int*, const int*, const T*, const T*, const float*, float*,
                        long long, int);

template <typename T, bool SKIP, int F>
Kernel<T> pick_lanes(int d_pad) {
  switch (lanes_for(F, d_pad)) {
    case 1: return sddmm_kernel<T, SKIP, F, 1>;
    case 2: return sddmm_kernel<T, SKIP, F, 2>;
    case 4: return sddmm_kernel<T, SKIP, F, 4>;
    case 8: return sddmm_kernel<T, SKIP, F, 8>;
    case 16: return sddmm_kernel<T, SKIP, F, 16>;
    default: return sddmm_kernel<T, SKIP, F, 32>;
  }
}

// The kernel for a dtype and width: F by features_for, L by lanes_for. The
// one place that picks the schedule.
template <typename T, bool SKIP>
Kernel<T> pick(int d_pad) {
  if constexpr (std::is_same<T, int8_t>::value) {
    if (features_for(1, d_pad) == 8) return pick_lanes<T, SKIP, 8>(d_pad);
    return pick_lanes<T, SKIP, 16>(d_pad);
  } else {
    return pick_lanes<T, SKIP, 16 / sizeof(T)>(d_pad);
  }
}

inline bool bad_shape(long long n_work, int d_pad) {
  return n_work <= 0 || n_work > (long long)kWarps * 0x7fffffffLL || d_pad <= 0 || d_pad % 8 != 0;
}

// Dynamic shared memory: kSpan running scores a warp where a row is walked
// in chunks (L = 32 and d_pad > 32 F), none otherwise.
template <typename T>
int smem_for(int d_pad) {
  const int f = features_for((int)sizeof(T), d_pad);
  return lanes_for(f, d_pad) * f < d_pad ? kWarps * kSpan * (int)sizeof(float) : 0;
}

inline dim3 grid_for(long long n_work) { return dim3((unsigned)((n_work + kWarps - 1) / kWarps)); }

template <typename T, bool SKIP>
int launch(const void* indptr, const void* indices, const void* rows, const void* a, const void* b,
           const void* g, void* out, long long n_work, int d_pad, cudaStream_t stream) {
  if (bad_shape(n_work, d_pad)) return (int)cudaErrorInvalidValue;
  if (std::is_same<T, int8_t>::value && g == nullptr) return (int)cudaErrorInvalidValue;
  pick<T, SKIP>(d_pad)<<<grid_for(n_work), kWarps * 32, smem_for<T>(d_pad), stream>>>(
      static_cast<const long long*>(indptr), static_cast<const int*>(indices), static_cast<const int*>(rows),
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<const float*>(g), static_cast<float*>(out),
      n_work, d_pad);
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

// async_copy::write_geometry's seven values (grid x, grid y, threads,
// dynamic shared memory (smem_for), B rows a lane has in flight (kU) in the
// stages slot, resident blocks an SM, resident blocks on the card), then
// L, G, kU, F and the warp shuffles of the tree a batch of G kU entries.
template <typename T>
int geometry(long long n_work, int d_pad, int* out) {
  if (bad_shape(n_work, d_pad)) return (int)cudaErrorInvalidValue;
  const Kernel<T> kernel = pick<T, false>(d_pad);
  cudaError_t err = async_copy::write_geometry(kernel, kWarps * 32, smem_for<T>(d_pad), grid_for(n_work), kU, out);
  // write_geometry left the kernel's dynamic shared memory limit at this
  // width's; the L = 32 kernel also serves chunked widths, which need kSpan
  // running scores a warp
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kWarps * kSpan * (int)sizeof(float));
  if (err != cudaSuccess) return (int)err;
  const int f = features_for((int)sizeof(T), d_pad), l = lanes_for(f, d_pad), rs = l < kU ? l : kU;
  out[7] = l;
  out[8] = 32 / l;
  out[9] = kU;
  out[10] = f;
  out[11] = kU / rs * (rs - 1 + log2_of(l / rs));
  return 0;
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

// The launch geometry of mggcn_sddmm over n_out rows of width d_pad in
// dtype (as theirs), written to out[0..11] (geometry above; mggcn_sddmm_qskip
// launches the same kernel over its live rows). Returns a cudaError_t.
int mggcn_sddmm_geometry(long long n_out, int d_pad, int dtype, int* out) {
  switch (dtype) {
    case 0: return geometry<float>(n_out, d_pad, out);
    case 1: return geometry<__nv_bfloat16>(n_out, d_pad, out);
    case 2: return geometry<int8_t>(n_out, d_pad, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* mggcn_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
