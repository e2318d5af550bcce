// Fused ring pattern SpMM pair for NVIDIA Hopper (sm_90a): one launch per
// partition and product sums all P rounds of the row-partitioned schedule.
//
// Replaces the two TPU kernels of mg_gcn_tpu/ops/spmm_pattern_ring.py:
//   ring_fwd_kernel  <-  _fwd_ring_kernel (spmm_pattern_ring.py:128):
//       C_j = sum_s pack_fwd[j, s]^T  B_{(j+s) % P}
//   ring_bwd_kernel  <-  _bwd_ring_kernel (spmm_pattern_ring.py:204):
//       C_j = sum_s pack_bwd[j, s]    G_{(j+s) % P}
// for partition j of P, each block m x m (m a multiple of 4096) in the
// strided bit layout of spmm_pattern.cu. pack_fwd[j, s] holds the bits of
// P[k_s row slab, j column slab] (its rows are the SOURCE slab's rows) and
// pack_bwd[j, s] those of P[j row slab, k_s column slab], k_s = (j+s) % P.
//
// Inputs: the partition's ring-ordered pack, int32 (P, m, m/32), and a slot
// buffer (P, m, d_pad) row-major on the same device, slot 0 the partition's
// own block and slot s the copy of partition k_s's block. The kernels read
// only memory of their own device: the exchange (ops/spmm_pattern_ring.py,
// parallel/dist.py) fills the slots before the launch, so the code is the
// same whether partitions share a card or not. The TPU kernel's RDMA ring,
// semaphores, VMEM staging, D_MAX chunking and bit-plane matmuls have no
// counterpart: the walks are the single-pack kernels' (pattern_fwd.cuh and
// pattern_bwd.cuh, shared with spmm_pattern.cu) with the rounds added,
// and the sums stay in registers across all rounds, with one store:
//   float32 / bfloat16 operands -> float32 sums;  int8 -> int32 sums.
// A round whose block has no set bit adds nothing; a column no round
// reaches (padded rows m*P > n among them) is stored as 0.
//
// What bounds them on an H100 SXM (3.35 TB/s): a partition's P blocks are
// P*m^2/8 bytes (1.9 GB at P = 4, m = 61,440) and each launch reads them
// once, >= 0.56 ms; the slots and C add P*m*d_pad + m*d_pad elements. The
// 2*nnz_j*d arithmetic is far below the float32 peak at Reddit density, so
// both are bound by bytes, as the single-pack kernels are. A partition's
// pack has a quarter of the main pack's words (1,920 at m = 61,440), too
// few column blocks to fill the card twice over, so the forward's launcher
// splits its P*m-row walk into row slices (pattern_fwd.cuh: clusters whose
// partials meet in distributed shared memory, added in slice order).
//
// Offsets are 64-bit throughout.

#include "pattern_bwd.cuh"
#include "pattern_fwd.cuh"

namespace {

using pattern::Mode;

// The rounds are consecutive row blocks of the stacked pack (P*m, m/32) and
// slots (P*m, d_pad): one forward walk over P*m rows sums them in order.
template <typename T, int G>
__global__ void __launch_bounds__(pattern::FwdCfg<G>::kThreads, pattern::FwdCfg<G>::kMinBlocks)
ring_fwd_kernel(const uint32_t* __restrict__ pack, const T* __restrict__ slots,
                typename Mode<T>::Acc* __restrict__ c, long long rows, long long words, int d_pad,
                int slices) {
  pattern::fwd_cols<T, G>(pack, slots, c, rows, words, d_pad, slices);
}

bool bad_shape(int parts, long long m, int d_pad) {
  return parts <= 0 || m <= 0 || m % pattern::kGroup != 0 || d_pad <= 0 || d_pad % 8 != 0;
}

// Two lane groups a warp at d_pad <= 64 (pattern_fwd.cuh).
template <typename T>
int launch_fwd(const void* pack, const void* slots, void* c, int parts, long long m, int d_pad,
               cudaStream_t stream) {
  const long long rows = (long long)parts * m, words = m / 32;
  if (d_pad <= 64)
    return (int)pattern::fwd_launch<T, 2>(ring_fwd_kernel<T, 2>, pack, slots, c, rows, words, d_pad, stream);
  return (int)pattern::fwd_launch<T, 1>(ring_fwd_kernel<T, 1>, pack, slots, c, rows, words, d_pad, stream);
}

template <typename T>
int geometry_fwd(int parts, long long m, int d_pad, int* out) {
  const long long rows = (long long)parts * m, words = m / 32;
  if (d_pad <= 64) return (int)pattern::fwd_geometry<T, 2>(ring_fwd_kernel<T, 2>, rows, words, d_pad, out);
  return (int)pattern::fwd_geometry<T, 1>(ring_fwd_kernel<T, 1>, rows, words, d_pad, out);
}

// Each output row walks its row of every round as one stream
// (pattern_bwd.cuh): round s at pack + s*m*words and slots + s*m*d_pad.
template <typename T>
int launch_bwd(const void* pack, const void* slots, void* c, int parts, long long m, int d_pad,
               cudaStream_t stream) {
  const int words = (int)(m / 32);
  return (int)pattern_bwd::launch<T>(pattern_bwd::pack_args(pack, words, parts, m * words), slots, c, m, d_pad,
                                     stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = int8 (C is int32). C is (m, d_pad).
// Returns a cudaError_t; 0 means the launch was accepted.
int mggcn_ring_fwd(const void* pack, const void* slots, void* c, int parts, long long m,
                   int d_pad, int dtype, void* stream) {
  if (bad_shape(parts, m, d_pad)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_fwd<float>(pack, slots, c, parts, m, d_pad, s);
    case 1: return launch_fwd<__nv_bfloat16>(pack, slots, c, parts, m, d_pad, s);
    case 2: return launch_fwd<int8_t>(pack, slots, c, parts, m, d_pad, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The forward's launch geometry, as mggcn_pattern_fwd_geometry (spmm_pattern.cu).
int mggcn_ring_fwd_geometry(int parts, long long m, int d_pad, int dtype, int* out) {
  if (bad_shape(parts, m, d_pad)) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return geometry_fwd<float>(parts, m, d_pad, out);
    case 1: return geometry_fwd<__nv_bfloat16>(parts, m, d_pad, out);
    case 2: return geometry_fwd<int8_t>(parts, m, d_pad, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

int mggcn_ring_bwd(const void* pack, const void* slots, void* c, int parts, long long m,
                   int d_pad, int dtype, void* stream) {
  if (bad_shape(parts, m, d_pad)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_bwd<float>(pack, slots, c, parts, m, d_pad, s);
    case 1: return launch_bwd<__nv_bfloat16>(pack, slots, c, parts, m, d_pad, s);
    case 2: return launch_bwd<int8_t>(pack, slots, c, parts, m, d_pad, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The backward's launch geometry, as mggcn_pattern_bwd_geometry (spmm_pattern.cu).
int mggcn_ring_bwd_geometry(int parts, long long m, int d_pad, int dtype, int* out) {
  if (bad_shape(parts, m, d_pad)) return (int)cudaErrorInvalidValue;
  const pattern_bwd::PackArgs src = pattern_bwd::pack_args(nullptr, (int)(m / 32), parts, 0);
  switch (dtype) {
    case 0: return (int)pattern_bwd::geometry<float>(src, m, d_pad, out);
    case 1: return (int)pattern_bwd::geometry<__nv_bfloat16>(src, m, d_pad, out);
    case 2: return (int)pattern_bwd::geometry<int8_t>(src, m, d_pad, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* mggcn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
