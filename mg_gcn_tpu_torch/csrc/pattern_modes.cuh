// Operand modes of the bit-packed pattern kernels: the forward pattern walk
// (pattern_fwd.cuh: each lane owns 4 consecutive features) and the block
// store's forward (spmm_pattern_sparse.cu) sum
//   float32 operand -> float32;  bfloat16 operand -> float32;
//   int8 operand    -> int32 (exact in any order);
// the backward walk (pattern_bwd.cuh) sums the same types in its own Vec.
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
  __device__ __forceinline__ static Raw raw(const float* p) { return __ldg(reinterpret_cast<const float4*>(p)); }
  __device__ __forceinline__ static Acc4 widen(const Raw& r) { return r; }
};

template <> struct Mode<__nv_bfloat16> {
  using Acc = float;
  using Acc4 = float4;
  using Raw = uint2;
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
  __device__ __forceinline__ static Raw raw(const int8_t* p) {
    return __ldg(reinterpret_cast<const char4*>(p));
  }
  __device__ __forceinline__ static Acc4 widen(Raw v) { return make_int4(v.x, v.y, v.z, v.w); }
};

}  // namespace pattern
