// Bit-packed dense-pattern SpMM pair for NVIDIA Hopper (sm_90a).
//
// Replaces the two TPU kernels of mg_gcn_tpu/ops/spmm_pattern.py:
//   pattern_fwd_kernel  <-  _fwd_kernel (spmm_pattern.py:265):  C = P^T B
//   pattern_bwd_kernel  <-  _bwd_kernel (spmm_pattern.py:280):  C = P   B
// Both read the same strided bit pack the JAX package builds: bit b of word
// pack[i, g*128 + w] holds P[i, g*4096 + b*128 + w]; a row has
// words = n_pad / 32 words and n_pad is a multiple of 4096. The TPU kernels'
// 32 bit-plane matmuls, D_MAX chunking and one-hot shapes worked around the
// MXU and are not reproduced: here each set bit is decoded and its dense row
// gathered (backward) or accumulated (forward) directly.
//
// B and C are row-major (n_pad, d_pad) with d_pad % 8 == 0; the wrapper
// (ops/spmm_pattern.py) pads. Operand modes, as on the TPU:
//   float32 operand -> float32 sums;  bfloat16 operand -> float32 sums;
//   int8 operand    -> int32 sums (exact in any order).
//
// What bounds them on an H100 SXM (3.35 TB/s): at Reddit scale
// (n_pad = 233,472) the pack is n_pad^2/8 = 6.8 GB and each launch reads it
// once, >= 2.0 ms. The 2*nnz*d arithmetic (115M edges x 128 features) is
// under 0.5 ms even on the 67 TFLOP/s float32 units, so both kernels are
// bound by bytes; each reads the pack once per 128-feature chunk and keeps
// every sum in registers until its one store. The dense-row traffic (one
// 4-feature slice per lane per set bit) goes through L2.
//
// Offsets into the pack (up to 1.7e9 words) and into B/C are 64-bit. The
// walks are shared with the ring kernels of spmm_pattern_ring.cu: the
// forward (sums in registers, bit tiles staged by cp.async into an
// mbarrier ring, row slices as clusters; its sum order) in
// pattern_fwd.cuh, the backward (the pack streamed by cp.async into a
// warp's ring of spans, a span's bits listed at once, lane groups sized to
// the row; its sum order) in pattern_bwd.cuh. This file runs them over one
// square pack.

#include "pattern_bwd.cuh"
#include "pattern_fwd.cuh"

namespace {

using pattern::Mode;

// The forward walk is pattern_fwd.cuh's, over one square pack; the
// backward walk's kernels are pattern_bwd.cuh's, launched with one round.
template <typename T, int G>
__global__ void __launch_bounds__(pattern::FwdCfg<G>::kThreads, pattern::FwdCfg<G>::kMinBlocks)
pattern_fwd_kernel(const uint32_t* __restrict__ pack, const T* __restrict__ b,
                   typename Mode<T>::Acc* __restrict__ c, long long n_pad, long long words,
                   int d_pad, int slices) {
  pattern::fwd_cols<T, G>(pack, b, c, n_pad, words, d_pad, slices);
}

bool bad_shape(long long n_pad, int d_pad) {
  return n_pad <= 0 || n_pad % pattern::kGroup != 0 || d_pad <= 0 || d_pad % 8 != 0;
}

// Two lane groups a warp at d_pad <= 64 (pattern_fwd.cuh).
template <typename T>
int launch_fwd(const void* pack, const void* b, void* c, long long n_pad, int d_pad,
               cudaStream_t stream) {
  const long long words = n_pad / 32;
  if (d_pad <= 64)
    return (int)pattern::fwd_launch<T, 2>(pattern_fwd_kernel<T, 2>, pack, b, c, n_pad, words, d_pad, stream);
  return (int)pattern::fwd_launch<T, 1>(pattern_fwd_kernel<T, 1>, pack, b, c, n_pad, words, d_pad, stream);
}

template <typename T>
int geometry_fwd(long long n_pad, int d_pad, int* out) {
  const long long words = n_pad / 32;
  if (d_pad <= 64) return (int)pattern::fwd_geometry<T, 2>(pattern_fwd_kernel<T, 2>, n_pad, words, d_pad, out);
  return (int)pattern::fwd_geometry<T, 1>(pattern_fwd_kernel<T, 1>, n_pad, words, d_pad, out);
}

template <typename T>
int launch_bwd(const void* pack, const void* b, void* c, long long n_pad, int d_pad,
               cudaStream_t stream) {
  return (int)pattern_bwd::launch<T>(pattern_bwd::pack_args(pack, (int)(n_pad / 32), 1, 0), b, c, n_pad, d_pad,
                                     stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = int8 (C is int32). Returns a
// cudaError_t; 0 means the launch was accepted.
int mggcn_pattern_fwd(const void* pack, const void* b, void* c, long long n_pad,
                      int d_pad, int dtype, void* stream) {
  if (bad_shape(n_pad, d_pad)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_fwd<float>(pack, b, c, n_pad, d_pad, s);
    case 1: return launch_fwd<__nv_bfloat16>(pack, b, c, n_pad, d_pad, s);
    case 2: return launch_fwd<int8_t>(pack, b, c, n_pad, d_pad, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The forward's launch geometry for these operands, written to out[0..6]:
// grid x, grid y, threads, dynamic shared memory, row slices (the cluster
// size), resident blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
// and resident blocks on the card. Returns a cudaError_t.
int mggcn_pattern_fwd_geometry(long long n_pad, int d_pad, int dtype, int* out) {
  if (bad_shape(n_pad, d_pad)) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return geometry_fwd<float>(n_pad, d_pad, out);
    case 1: return geometry_fwd<__nv_bfloat16>(n_pad, d_pad, out);
    case 2: return geometry_fwd<int8_t>(n_pad, d_pad, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

int mggcn_pattern_bwd(const void* pack, const void* b, void* c, long long n_pad,
                      int d_pad, int dtype, void* stream) {
  if (bad_shape(n_pad, d_pad)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_bwd<float>(pack, b, c, n_pad, d_pad, s);
    case 1: return launch_bwd<__nv_bfloat16>(pack, b, c, n_pad, d_pad, s);
    case 2: return launch_bwd<int8_t>(pack, b, c, n_pad, d_pad, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The backward's launch geometry, written to out[0..12]: grid x, grid y,
// threads, dynamic shared memory, stages, resident blocks an SM, resident
// blocks on the card, lanes, groups, features a lane loads, B rows a lane
// loads at once, pack words a span and column windows, walked in turn by
// the one launch (pattern_bwd.cuh).
// Returns a cudaError_t.
int mggcn_pattern_bwd_geometry(long long n_pad, int d_pad, int dtype, int* out) {
  if (bad_shape(n_pad, d_pad)) return (int)cudaErrorInvalidValue;
  const pattern_bwd::PackArgs src = pattern_bwd::pack_args(nullptr, (int)(n_pad / 32), 1, 0);
  switch (dtype) {
    case 0: return (int)pattern_bwd::geometry<float>(src, n_pad, d_pad, out);
    case 1: return (int)pattern_bwd::geometry<__nv_bfloat16>(src, n_pad, d_pad, out);
    case 2: return (int)pattern_bwd::geometry<int8_t>(src, n_pad, d_pad, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* mggcn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
