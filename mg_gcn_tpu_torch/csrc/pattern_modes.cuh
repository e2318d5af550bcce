// Operand modes of the bit-packed pattern kernels (spmm_pattern.cu and
// spmm_pattern_sparse.cu): each lane owns 4 consecutive features and sums
//   float32 operand -> float32;  bfloat16 operand -> float32;
//   int8 operand    -> int32 (exact in any order).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace pattern {

constexpr int kGroup = 4096;          // pattern columns per 128-word group
constexpr int kLaneF = 4;             // features per lane
constexpr int kChunkF = 32 * kLaneF;  // features per block (grid chunks)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void zero(float4& a) { a = make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ void zero(int4& a) { a = make_int4(0, 0, 0, 0); }
__device__ __forceinline__ void add(float4& a, const float4& v) {
  a.x += v.x; a.y += v.y; a.z += v.z; a.w += v.w;
}
__device__ __forceinline__ void add(int4& a, const int4& v) {
  a.x += v.x; a.y += v.y; a.z += v.z; a.w += v.w;
}

// Operand type -> accumulator type and a 4-feature load widened to it.
template <typename T> struct Mode;

// ``raw`` loads 4 features as stored and ``widen`` converts them, so that a
// batch of loads can be in flight in few registers.
template <> struct Mode<float> {
  using Acc = float;
  using Acc4 = float4;
  using Raw = float4;
  __device__ __forceinline__ static Acc4 load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ __forceinline__ static Raw raw(const float* p) { return load(p); }
  __device__ __forceinline__ static Acc4 widen(const Raw& r) { return r; }
};

template <> struct Mode<__nv_bfloat16> {
  using Acc = float;
  using Acc4 = float4;
  using Raw = uint2;
  __device__ __forceinline__ static Acc4 load(const __nv_bfloat16* p) { return widen(raw(p)); }
  __device__ __forceinline__ static Raw raw(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint2*>(p));
  }
  __device__ __forceinline__ static Acc4 widen(Raw r) {
    const float2 lo = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&r.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&r.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
};

template <> struct Mode<int8_t> {
  using Acc = int;
  using Acc4 = int4;
  using Raw = char4;
  __device__ __forceinline__ static Acc4 load(const int8_t* p) { return widen(raw(p)); }
  __device__ __forceinline__ static Raw raw(const int8_t* p) {
    return __ldg(reinterpret_cast<const char4*>(p));
  }
  __device__ __forceinline__ static Acc4 widen(Raw v) { return make_int4(v.x, v.y, v.z, v.w); }
};

// One warp adds B[j, chunk] into ``acc`` for every set bit of the 32 words
// ``word`` (one a lane) whose bit b stands for column ``jbase + b*128``
// (jbase is this lane's). The set bits are listed in ``list`` (32*32 ints
// of shared memory, this warp's own) in (lane, bit) order by a prefix sum
// of the lanes' counts, then gathered four rows at a time: the sum order
// is fixed and no atomics are used. ``bcol`` is B + this lane's first
// feature; inactive lanes load nothing.
template <typename T>
__device__ __forceinline__ void gather_bits(uint32_t word, int jbase, int* list, const T* bcol,
                                            int d_pad, bool active, typename Mode<T>::Acc4& acc) {
  using Acc4 = typename Mode<T>::Acc4;
  const int lane = threadIdx.x & 31;
  const int cnt = __popc(word);
  int incl = cnt;  // inclusive prefix sum of the set-bit counts over lanes
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += t;
  }
  const int total = __shfl_sync(kFull, incl, 31);
  if (total == 0) return;
  int pos = incl - cnt;
  while (word) {
    const int bit = __ffs(word) - 1;
    word &= word - 1;
    list[pos++] = jbase + bit * 128;
  }
  __syncwarp();
  int e = 0;
  for (; e + 4 <= total; e += 4) {
    Acc4 v0, v1, v2, v3;
    zero(v0); zero(v1); zero(v2); zero(v3);
    if (active) {
      v0 = Mode<T>::load(bcol + (size_t)list[e] * d_pad);
      v1 = Mode<T>::load(bcol + (size_t)list[e + 1] * d_pad);
      v2 = Mode<T>::load(bcol + (size_t)list[e + 2] * d_pad);
      v3 = Mode<T>::load(bcol + (size_t)list[e + 3] * d_pad);
    }
    add(acc, v0); add(acc, v1); add(acc, v2); add(acc, v3);
  }
  for (; e < total; ++e) {
    if (active) add(acc, Mode<T>::load(bcol + (size_t)list[e] * d_pad));
  }
  __syncwarp();  // the list is rewritten by the next call
}

}  // namespace pattern
