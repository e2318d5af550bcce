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
// bound by bytes; the design reads the pack exactly once per 128-feature
// chunk and keeps every sum on chip until its one store. The dense-row
// traffic (one 4-feature slice per lane per set bit) goes through L2.
//
// Offsets into the pack (up to 1.7e9 words) and into B/C are 64-bit.

#include "pattern_modes.cuh"

namespace {

using pattern::add;
using pattern::kChunkF;
using pattern::kFull;
using pattern::kGroup;
using pattern::kLaneF;
using pattern::Mode;
using pattern::zero;

constexpr int kFwdWords = 8;           // forward: words (= warps) per block
constexpr int kFwdRows = 128;          // forward: pack rows per staged tile
constexpr int kBwdRows = 8;            // backward: rows (= warps) per block

// Backward, C = P B. One warp per output row; each lane owns 4 features of
// the block's 128-feature chunk. The warp streams its row's words 128 at a
// time (16 B a lane, coalesced, the next span's load in flight), skips an
// all-zero span with one vote, decodes the set bits of each 32-word
// sub-span into a per-warp list of columns j, then gathers B[j, chunk] four
// rows at a time into register sums. Sums run in (word, bit) order: the
// result is deterministic and no atomics are used.
template <typename T>
__global__ void __launch_bounds__(kBwdRows * 32)
pattern_bwd_kernel(const uint32_t* __restrict__ pack, const T* __restrict__ b,
                   typename Mode<T>::Acc* __restrict__ c, long long words, int d_pad) {
  using Acc4 = typename Mode<T>::Acc4;
  __shared__ int cols[kBwdRows][32 * 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long i = (long long)blockIdx.x * kBwdRows + warp;
  const int f0 = blockIdx.y * kChunkF + lane * kLaneF;
  const bool active = f0 < d_pad;
  int* list = cols[warp];
  const T* bcol = b + f0;

  Acc4 acc;
  zero(acc);
  const uint4* row = reinterpret_cast<const uint4*>(pack + i * words);
  uint4 next = __ldg(row + lane);
  for (long long base = 0; base < words; base += 128) {
    const uint4 cur = next;
    if (base + 128 < words) next = __ldg(row + (base + 128) / 4 + lane);
    if (!__any_sync(kFull, (cur.x | cur.y | cur.z | cur.w) != 0u)) continue;
    const uint32_t span[4] = {cur.x, cur.y, cur.z, cur.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const long long wi = base + 4 * lane + q;  // this lane's word index
      pattern::gather_bits<T>(span[q], (int)(wi >> 7) * kGroup + (int)(wi & 127), list, bcol, d_pad,
                              active, acc);
    }
  }
  if (active) *reinterpret_cast<Acc4*>(c + i * d_pad + f0) = acc;
}

// Forward, C = P^T B: C[j, :] = sum_i P[i, j] B[i, :]. A column of the
// row-major pack is strided, so a block owns 8 consecutive words of one
// group (one word per warp = 256 output columns) and walks ALL rows in
// order, staging a 128-row x 8-word tile (32 B a row) in shared memory with
// the next tile's load in flight. Each warp keeps a shared-memory sum for its
// 32 columns x the chunk's features; for its nonzero words it loads
// B[i, chunk] four rows at a time and adds it to the sum of every set bit.
// Each sum element belongs to one lane and is summed in row order: the result
// is deterministic and no atomics are used. Only the shared n^2/8 pack is
// read; no transposed copy of the pattern is stored.
template <typename T>
__global__ void __launch_bounds__(kFwdWords * 32)
pattern_fwd_kernel(const uint32_t* __restrict__ pack, const T* __restrict__ b,
                   typename Mode<T>::Acc* __restrict__ c, long long n_pad,
                   long long words, int d_pad) {
  using Acc = typename Mode<T>::Acc;
  using Acc4 = typename Mode<T>::Acc4;
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* tile = reinterpret_cast<uint4*>(smem);  // [kFwdRows][2] x 4 words
  const uint32_t* tile_words = reinterpret_cast<const uint32_t*>(smem);
  Acc* sums = reinterpret_cast<Acc*>(smem + kFwdRows * kFwdWords * sizeof(uint32_t));

  const int fc = min(kChunkF, d_pad - (int)blockIdx.y * kChunkF);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long w_first = (long long)blockIdx.x * kFwdWords;
  const int f0 = blockIdx.y * kChunkF + lane * kLaneF;
  const bool active = lane * kLaneF < fc;
  for (int t = threadIdx.x; t < kFwdWords * 32 * fc; t += blockDim.x) sums[t] = Acc(0);
  Acc* mine = sums + warp * 32 * fc + lane * kLaneF;  // + bit * fc

  // thread t stages half a tile row: row t/2, words 4*(t%2) .. 4*(t%2)+3
  const uint32_t* src =
      pack + (long long)(threadIdx.x >> 1) * words + w_first + 4 * (threadIdx.x & 1);
  uint4 next = __ldg(reinterpret_cast<const uint4*>(src));
  for (long long r0 = 0; r0 < n_pad; r0 += kFwdRows) {
    __syncthreads();  // the previous tile is consumed (and the sums zeroed)
    tile[threadIdx.x] = next;
    __syncthreads();
    if (r0 + kFwdRows < n_pad)
      next = __ldg(reinterpret_cast<const uint4*>(src + (r0 + kFwdRows) * words));
    for (int s = 0; s < kFwdRows; s += 32) {
      const uint32_t w = tile_words[(s + lane) * kFwdWords + warp];
      unsigned m = __ballot_sync(kFull, w != 0u);
      while (m) {
        int r[4];
        uint32_t bits[4];
        Acc4 v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {  // up to 4 nonzero rows at once
          r[q] = m ? __ffs(m) - 1 : -1;
          m &= m - 1;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          bits[q] = __shfl_sync(kFull, w, r[q] < 0 ? 0 : r[q]);
          zero(v[q]);
          if (r[q] >= 0 && active)
            v[q] = Mode<T>::load(b + (size_t)(r0 + s + r[q]) * d_pad + f0);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          uint32_t x = r[q] < 0 ? 0u : bits[q];
          while (x) {
            const int bit = __ffs(x) - 1;
            x &= x - 1;
            if (active) {
              Acc4* a = reinterpret_cast<Acc4*>(mine + bit * fc);
              Acc4 t = *a;
              add(t, v[q]);
              *a = t;
            }
          }
        }
      }
    }
  }
  // each lane reads back only the sum elements it wrote
  const long long wi = w_first + warp;
  const long long jbase = (wi >> 7) * kGroup + (wi & 127);
  if (active) {
    for (int bit = 0; bit < 32; ++bit)
      *reinterpret_cast<Acc4*>(c + (jbase + bit * 128) * d_pad + f0) =
          *reinterpret_cast<const Acc4*>(mine + bit * fc);
  }
}

bool bad_shape(long long n_pad, int d_pad) {
  return n_pad <= 0 || n_pad % kGroup != 0 || d_pad <= 0 || d_pad % 8 != 0;
}

template <typename T>
int launch_fwd(const void* pack, const void* b, void* c, long long n_pad, int d_pad,
               cudaStream_t stream) {
  using Acc = typename Mode<T>::Acc;
  const long long words = n_pad / 32;
  const int fc_max = d_pad < kChunkF ? d_pad : kChunkF;
  const size_t smem = (size_t)kFwdRows * kFwdWords * sizeof(uint32_t) +
                      (size_t)kFwdWords * 32 * fc_max * sizeof(Acc);
  cudaError_t err = cudaFuncSetAttribute(
      pattern_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(words / kFwdWords), (unsigned)((d_pad + kChunkF - 1) / kChunkF));
  pattern_fwd_kernel<T><<<grid, kFwdWords * 32, smem, stream>>>(
      static_cast<const uint32_t*>(pack), static_cast<const T*>(b),
      static_cast<Acc*>(c), n_pad, words, d_pad);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* pack, const void* b, void* c, long long n_pad, int d_pad,
               cudaStream_t stream) {
  using Acc = typename Mode<T>::Acc;
  const dim3 grid((unsigned)(n_pad / kBwdRows), (unsigned)((d_pad + kChunkF - 1) / kChunkF));
  pattern_bwd_kernel<T><<<grid, kBwdRows * 32, 0, stream>>>(
      static_cast<const uint32_t*>(pack), static_cast<const T*>(b),
      static_cast<Acc*>(c), n_pad / 32, d_pad);
  return (int)cudaGetLastError();
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

const char* mggcn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
